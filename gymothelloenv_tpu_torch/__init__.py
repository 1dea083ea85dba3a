"""PyTorch/CUDA port of ``gymothelloenv_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its layout
(``core/``, ``ops/``, ``envs/``, ``models/``, ``policies/``, ``train/``) so
each module's counterpart is easy to find.  It imports only ``torch``,
``numpy`` and the standard library.

Board word: one side of an 8x8 board is ONE 64-bit word, bit ``k`` = cell
``k`` row-major (``word = w0 | w1 << 32`` of the JAX uint32 pair).  On the
card it is ``uint64_t``; in plain torch it is ``torch.int64`` read as raw
bits, so every right shift goes through ``core.bitboard.lsr``.  Other
board sizes keep int8 ``(N, B, B)`` planes (``core/state.py``,
``core/bitops.py``); ``core.engine.get_engine`` picks the layout.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises.
The hand-written kernels live in ``csrc/`` and are built by
``ops/_build.py`` (one ``nvcc`` call, loaded with ``ctypes``).
"""

__version__ = "0.1.0"
