"""The ply kernel: one whole ``bit_step`` for every game in one launch.

There is no Pallas kernel to replace: JAX's
``gymothelloenv_tpu/core/bitboard.py::bit_step`` is fused by XLA.  The
kernel (``csrc/step.cu``) carries K2's legal floods on the port's main
path, along with the flips, the terminal rules, the select of
``BitEngine.step_where`` (``do``), the env's auto-reset and
``reset_where``.  ``bit_step`` is the one entry point of a ply.  Its
plain versions are ``core.bitboard.bit_step_plain`` and
``reset_where_plain``, used for CPU tensors only; a CUDA tensor always
goes to the kernel, or the wrapper raises.

A wrapper call allocates the words as one ``(3, N)`` int64 tensor, the
small fields as one int8 tensor and (``bit_step``) the reward, and returns
the state's fields as row views of them: at the main path's N the host's
time a call, not the kernel, is the ply's cost.
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard
from gymothelloenv_tpu_torch.core.bitboard import BitState, BitStepResult
from gymothelloenv_tpu_torch.ops import _build

# otb_bit_step's mode argument (csrc/step.cu kPlain, kWhere, kAutoreset).
MODES = {"plain": 0, "where": 1, "autoreset": 2}

_FIELDS = (("black", torch.int64), ("white", torch.int64),
           ("legal", torch.int64), ("turn", torch.int8),
           ("terminated", torch.bool), ("winner", torch.int8))


def _mode(do, autoreset: bool) -> str:
    if do is not None and autoreset:
        raise ValueError("bit_step: unknown mode: `do` (step_where) and "
                         "`autoreset` (bitvec_step) do not combine")
    return "where" if do is not None else "autoreset" if autoreset else \
        "plain"


def _check(name: str, state: BitState, extra) -> torch.device:
    """Refuse a state or an ``extra`` ``(label, tensor, dtype)`` input of
    the wrong dtype, shape or device; return the device."""
    ref = state.black
    shape, dev = ref.shape, ref.device
    inputs = [(f, getattr(state, f), d) for f, d in _FIELDS] + extra
    for label, t, dtype in inputs:
        if t.dtype is not dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
        if t.shape != shape or len(shape) != 1:
            raise ValueError(f"{name}: {label} must be (N,) like black "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, black on "
                             f"{dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous()
                                      for _, t, _ in inputs):
        raise ValueError(f"{name} needs contiguous inputs on the card")
    return dev


def _state_ptrs(state: BitState):
    return tuple(getattr(state, f).data_ptr() for f, _ in _FIELDS)


def _views(words: torch.Tensor, small: torch.Tensor):
    """The state as row views of the ``(3, N)`` words and the ``(k, N)``
    small fields (turn, terminated, winner[, done]), and the small rows
    after the state's."""
    black, white, legal = words.unbind(0)
    turn, terminated, winner, *rest = small.unbind(0)
    state = BitState(black=black, white=white, legal=legal, turn=turn,
                     terminated=terminated.view(torch.bool), winner=winner)
    return state, rest


def bit_step(state: BitState, action: torch.Tensor,
             sudden_death_on_invalid_move: bool = True,
             num_disk_as_reward: bool = False,
             do: torch.Tensor | None = None,
             autoreset: bool = False) -> BitStepResult:
    """One ply for every game (``bit_step_plain``; ``do`` and
    ``autoreset`` as there).  ``action``: int64 (N,); ``do``: bool (N,).
    CPU tensors take the plain version; CUDA tensors launch the ply kernel
    on the current stream (one thread per game, 36 B read and 32 B
    written)."""
    mode = _mode(do, autoreset)
    extra = [("action", action, torch.int64)]
    if do is not None:
        extra.append(("do", do, torch.bool))
    dev = _check("bit_step", state, extra)
    if dev.type == "cpu":
        return bitboard.bit_step_plain(
            state, action, sudden_death_on_invalid_move, num_disk_as_reward,
            do=do, autoreset=autoreset)
    n = action.shape[0]
    words = torch.empty((3, n), dtype=torch.int64, device=dev)
    small = torch.empty((4, n), dtype=torch.int8, device=dev)
    reward = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        lib = _build.load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.otb_bit_step(
            *_state_ptrs(state), action.data_ptr(),
            None if do is None else do.data_ptr(), words.data_ptr(),
            small.data_ptr(), reward.data_ptr(), n,
            int(sudden_death_on_invalid_move), int(num_disk_as_reward),
            MODES[mode], dev.index, stream), "bit_step")
        bit_step.launches += 1
    state, (done,) = _views(words, small)
    return BitStepResult(state=state, reward=reward,
                         done=done.view(torch.bool))


bit_step.launches = 0


def reset_where(state: BitState, done: torch.Tensor) -> BitState:
    """Games where ``done`` (bool (N,)) at the opening, the rest
    unchanged.  CPU tensors take ``reset_where_plain``; CUDA tensors
    launch ``otb_reset_where`` on the current stream."""
    dev = _check("reset_where", state, [("done", done, torch.bool)])
    if dev.type == "cpu":
        return bitboard.reset_where_plain(state, done)
    n = done.shape[0]
    words = torch.empty((3, n), dtype=torch.int64, device=dev)
    small = torch.empty((3, n), dtype=torch.int8, device=dev)
    if n:
        lib = _build.load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.otb_reset_where(
            *_state_ptrs(state), done.data_ptr(), words.data_ptr(),
            small.data_ptr(), n, dev.index, stream), "reset_where")
        reset_where.launches += 1
    return _views(words, small)[0]


reset_where.launches = 0
