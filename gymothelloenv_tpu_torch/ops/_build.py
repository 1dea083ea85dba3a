"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` into a plain shared library
with a C interface, ``gymothelloenv_tpu_torch/_build/libkernels.so``, which
is loaded with ``ctypes``.  No source includes PyTorch's headers, so the
build takes seconds, not the minutes a ``torch.utils.cpp_extension`` build
takes.  The library is rebuilt only when the hash of the sources and flags
changes.  A missing or failing ``nvcc`` raises with the compiler's output:
there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libkernels.so"
_HASH_FILE = BUILD_DIR / "libkernels.sha256"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
# C entry points: name -> argtypes.  Every one returns cudaGetLastError().
_SIGNATURES = {
    # mine, opp, out, n, device, stream
    "otb_legal_mask": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
    # cur, opp, legal, cur_out, opp_out, legal_out, episodes, words,
    # n, num_steps, seed, lanes, device, stream
    "otb_rollout": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                    _P),
    # up to seed the same, then variant, unroll, threads per block, lanes,
    # device, stream
    "otb_rollout_variant": (_P, _P, _P, _P, _P, _P, _P, _P,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P),
    # black, white, legal, turn, terminated, winner, action, do, words_out,
    # small_out, reward_out, n, sudden, disk_reward, mode, device, stream
    "otb_bit_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, _P),
    # black, white, legal, turn, terminated, winner, done, words_out,
    # small_out, n, device, stream
    "otb_reset_where": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        ctypes.c_longlong, ctypes.c_int, _P),
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    built: bool        # False when an up-to-date library was reused
    seconds: float     # wall time of the nvcc call (0 when reused)
    log: str           # nvcc's output (ptxas resource usage)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` unless the library matches the sources."""
    digest = source_hash()
    if (LIBRARY.is_file() and _HASH_FILE.is_file()
            and _HASH_FILE.read_text().strip() == digest):
        return BuildInfo(LIBRARY, False, 0.0, "")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, LIBRARY)
    _HASH_FILE.write_text(digest + "\n")
    return BuildInfo(LIBRARY, True, seconds, proc.stderr + proc.stdout)


_lib = None


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
