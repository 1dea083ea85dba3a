"""Carry flax ``PolicyNet`` weights across to the port's ``PolicyNet``.

The input is the flax param tree with numpy leaves (``ConvTrunk_0/
Conv_{0,1,2}``, ``Dense_0`` fc, ``Dense_1`` value, ``Dense_2`` logits),
with or without the outer ``{"params": ...}`` level.  Conv kernels go from
HWIO to OIHW and Dense kernels are transposed; the trunk's NHWC flatten
keeps the fc weights in JAX's row order.
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.utils.device import resolve_device


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: flax shape {tuple(src.shape)} does not "
                         f"fit {tuple(dst.shape)}")
    dst.copy_(src)


def policy_net_from_flax(params, width_mult: int, hidden_size: int,
                         device=None) -> PolicyNet:
    """Build the port's ``PolicyNet`` from a flax ``PolicyNet`` param tree
    (feed-forward, ``conv`` trunk)."""
    device = resolve_device(device)
    p = params.get("params", params)
    net = PolicyNet(hidden_size=hidden_size, width_mult=width_mult)
    trunk = p["ConvTrunk_0"]
    convs = (net.trunk.conv0, net.trunk.conv1, net.trunk.conv2)
    denses = ((net.fc, "Dense_0"), (net.value, "Dense_1"),
              (net.logits, "Dense_2"))
    with torch.no_grad():
        for i, conv in enumerate(convs):
            leaf = trunk[f"Conv_{i}"]
            _copy(conv.weight, np.transpose(leaf["kernel"], (3, 2, 0, 1)),
                  f"Conv_{i}.kernel")
            _copy(conv.bias, leaf["bias"], f"Conv_{i}.bias")
        for layer, name in denses:
            _copy(layer.weight, np.transpose(p[name]["kernel"]),
                  f"{name}.kernel")
            _copy(layer.bias, p[name]["bias"], f"{name}.bias")
    return net.to(device).eval()
