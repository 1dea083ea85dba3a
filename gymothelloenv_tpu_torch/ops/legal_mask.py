"""Kernel K2: batched 8-direction legal-move flood.

Replaces ``gymothelloenv_tpu/ops/pallas_bitboard.py::legal_mask_pallas``
(kernel ``_legal_kernel``).  The CUDA kernel is ``csrc/legal_mask.cu``; its
plain PyTorch version is ``core.bitboard.legal_mask``, used for CPU
tensors only.  A CUDA tensor always goes to the kernel, or the wrapper
raises.  It runs on perft's levels (``core/perft.py``: both sides' masks
of a frontier in one launch) and on its own benchmark,
``scripts/bench_legal_mask.py``; every ply's legal floods run inside the
ply kernel (``ops/step.py``).
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard
from gymothelloenv_tpu_torch.ops import _build

legal_mask_plain = bitboard.legal_mask


def _check(mine: torch.Tensor, opp: torch.Tensor) -> None:
    if mine.dtype != torch.int64 or opp.dtype != torch.int64:
        raise TypeError(f"legal_mask takes int64 words, got {mine.dtype} "
                        f"and {opp.dtype}")
    if mine.shape != opp.shape or mine.dim() != 1:
        raise ValueError(f"legal_mask takes two (N,) word tensors, got "
                         f"{tuple(mine.shape)} and {tuple(opp.shape)}")
    if mine.device != opp.device:
        raise ValueError(f"legal_mask inputs on {mine.device} and "
                         f"{opp.device}")


def legal_mask(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Legal placements (int64 words, (N,)) for ``mine`` against ``opp``.
    CPU tensors take the plain version; CUDA tensors launch K2 on the
    current stream (one thread per board, 16 B read and 8 B written)."""
    _check(mine, opp)
    if mine.device.type == "cpu":
        return legal_mask_plain(mine, opp)
    if mine.device.type != "cuda":
        raise ValueError(f"legal_mask runs on cpu or cuda, not {mine.device}")
    if not (mine.is_contiguous() and opp.is_contiguous()):
        raise ValueError("legal_mask needs contiguous inputs on the card")
    out = torch.empty_like(mine)
    n = mine.numel()
    if n == 0:
        return out
    lib = _build.load_library()
    dev = mine.device.index
    stream = torch.cuda.current_stream(mine.device).cuda_stream
    _build.check(lib.otb_legal_mask(mine.data_ptr(), opp.data_ptr(),
                                    out.data_ptr(), n, dev, stream),
                 "legal_mask")
    legal_mask.launches += 1
    return out


legal_mask.launches = 0
