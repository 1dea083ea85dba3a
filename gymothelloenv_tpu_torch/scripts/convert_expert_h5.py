"""Convert reference-format expert trajectory .h5 files to the npz layout
of ``agents/gail.ExpertDataset`` — the port of
``scripts/convert_expert_h5.py`` (the reference's
gail_experts/convert_to_pytorch.py, h5 -> pt, here h5 -> npz).

Usage: python -m gymothelloenv_tpu_torch.scripts.convert_expert_h5 \
    trajs_env.h5 [out.npz]

Reading an .h5 needs ``h5py`` (``agents.gail._load_trajectories`` raises
an error that names it without); ``ExpertDataset`` also reads the .h5
directly, so the conversion is optional.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from gymothelloenv_tpu_torch.agents.gail import _load_trajectories


def write_npz(dst: str, data) -> None:
    """``states`` float32, ``actions`` float32 and ``lengths`` int64 of
    ``data`` (a mapping of the three arrays) to ``dst``, as JAX's script
    writes them."""
    np.savez(dst, states=np.asarray(data["states"], np.float32),
             actions=np.asarray(data["actions"], np.float32),
             lengths=np.asarray(data["lengths"], np.int64))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else os.path.splitext(src)[0] + ".npz"
    data = _load_trajectories(src)
    write_npz(dst, data)
    print(f"wrote {dst}: states{data['states'].shape} "
          f"actions{data['actions'].shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
