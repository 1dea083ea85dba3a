"""Carry ``PolicyNet`` weights between flax's param tree and the port.

The flax tree has numpy leaves (``ConvTrunk_0/Conv_{0,1,2}``, ``Dense_0``
fc, ``Dense_1`` value, ``Dense_2`` logits, and for a recurrent net
``GRUCore_0/GRUCell_0/{ir,iz,in,hr,hz,hn}``), with or without the outer
``{"params": ...}`` level.  Conv kernels are HWIO in flax and OIHW here;
Dense kernels are ``(in, out)`` in flax and ``(out, in)`` here; the
trunk's NHWC flatten keeps the fc weights in JAX's row order.  The same
mapping carries any per-parameter tensor, such as Adam's moments
(``agents/ppo.Optimizer``).
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.utils.device import resolve_device

_GRU = ("GRUCore_0", "GRUCell_0")
_MODULES = {"trunk.conv0": ("ConvTrunk_0", "Conv_0"),
            "trunk.conv1": ("ConvTrunk_0", "Conv_1"),
            "trunk.conv2": ("ConvTrunk_0", "Conv_2"),
            "fc": ("Dense_0",), "value": ("Dense_1",),
            "logits": ("Dense_2",),
            **{f"gru.{leaf}": _GRU + (leaf.rstrip("_"),)
               for leaf in ("ir", "iz", "in_", "hr", "hz", "hn")}}
_LEAVES = {"weight": "kernel", "bias": "bias"}


def _flax_path(name: str) -> tuple:
    """A ``PolicyNet`` parameter name -> its path in the flax tree."""
    module, leaf = name.rsplit(".", 1)
    return _MODULES[module] + (_LEAVES[leaf],)


def _to_flax_layout(t: torch.Tensor) -> np.ndarray:
    """OIHW -> HWIO, ``(out, in)`` -> ``(in, out)``; float32 numpy."""
    a = t.detach().to("cpu", torch.float32).numpy()
    if a.ndim == 4:
        a = np.transpose(a, (2, 3, 1, 0))
    elif a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def _from_flax_layout(a, like: torch.Tensor, name: str) -> torch.Tensor:
    """The inverse of ``_to_flax_layout``, shaped and placed like ``like``;
    a flax leaf of another shape raises."""
    a = np.asarray(a)
    stored = tuple(a.shape)
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    elif a.ndim == 2:
        a = a.T
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{name}: flax shape {stored} does not fit "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(like.device)


def flax_tree(net: PolicyNet, tensors=None) -> dict:
    """``{"params": {...}}`` of ``tensors`` (default: the net's parameters;
    one tensor per ``net.parameters()`` entry, in its order) in flax
    layout."""
    names = [name for name, _ in net.named_parameters()]
    if tensors is None:
        tensors = list(net.parameters())
    tree: dict = {}
    for name, t in zip(names, tensors, strict=True):
        *outer, leaf = _flax_path(name)
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = _to_flax_layout(t)
    return {"params": tree}


def tensors_from_flax(net: PolicyNet, tree) -> list:
    """One tensor per ``net.parameters()`` entry from a flax tree, in the
    port's layout on the net's device.  A missing or extra leaf, or one
    of another shape, raises ``ValueError``."""
    p = tree.get("params", tree) if isinstance(tree, dict) else tree
    out, seen = [], set()
    for name, param in net.named_parameters():
        path = _flax_path(name)
        node = p
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"flax tree has no {'/'.join(path)}")
            node = node[key]
        out.append(_from_flax_layout(node, param, "/".join(path)))
        seen.add(path)
    extra = ["/".join(path) for path, _ in flax_leaves(p)
             if path not in seen]
    if extra:
        kind = "recurrent" if net.recurrent else "feed-forward"
        raise ValueError(f"flax tree leaves the {kind} PolicyNet does "
                         f"not have: {extra[:3]}")
    return out


def flax_leaves(tree, path=()):
    """``(path, leaf)`` of a nested dict in ``jax.tree_util``'s order
    (sorted keys)."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for key in sorted(tree):
        yield from flax_leaves(tree[key], path + (key,))


def load_flax_params(net: PolicyNet, params) -> PolicyNet:
    """Copy a flax param tree into ``net`` in place."""
    tensors = tensors_from_flax(net, params)
    with torch.no_grad():
        for param, t in zip(net.parameters(), tensors):
            param.copy_(t)
    return net


def architecture(params) -> dict:
    """``PolicyNet``'s capacity from a flax tree's stored shapes, as JAX's
    ``load_eval_policy`` infers it (ppo_trainer.py:352-358):
    ``width_mult``, ``hidden_size``, ``recurrent`` (a ``GRUCore_0``) and
    ``frame_stack`` (``Conv_0``'s input channels over 4)."""
    p = params.get("params", params)
    conv0 = np.shape(p["ConvTrunk_0"]["Conv_0"]["kernel"])
    return dict(width_mult=int(conv0[-1]) // 32,
                hidden_size=int(np.shape(p["Dense_0"]["kernel"])[-1]),
                recurrent="GRUCore_0" in p,
                frame_stack=int(conv0[-2]) // 4)


def policy_net_from_flax(params, width_mult: int | None = None,
                         hidden_size: int | None = None, device=None,
                         dtype: torch.dtype = torch.float32) -> PolicyNet:
    """Build the port's ``PolicyNet`` from a flax ``PolicyNet`` param tree
    (``conv`` trunk): recurrent where the tree has a ``GRUCore_0``, with
    ``4 x frame_stack`` input channels as ``Conv_0`` stores them.
    ``width_mult`` and ``hidden_size`` default to the stored ones; given,
    a tree of another capacity raises ``ValueError``."""
    device = resolve_device(device)
    arch = architecture(params)
    net = PolicyNet(hidden_size=hidden_size or arch["hidden_size"],
                    width_mult=width_mult or arch["width_mult"],
                    recurrent=arch["recurrent"],
                    in_channels=4 * arch["frame_stack"], dtype=dtype)
    return load_flax_params(net.to(device), params).eval()
