"""Carry ``PolicyNet`` (and every other net of the port) weights between
flax's param tree and the port.

The flax tree has numpy leaves (``ConvTrunk_0/Conv_{0,1,2}``, ``Dense_0``
fc, ``Dense_1`` value, ``Dense_2`` logits, and for a recurrent net
``GRUCore_0/GRUCell_0/{ir,iz,in,hr,hz,hn}``), with or without the outer
``{"params": ...}`` level.  Conv kernels are HWIO in flax and OIHW here;
Dense kernels are ``(in, out)`` in flax and ``(out, in)`` here; the
trunk's NHWC flatten keeps the fc weights in JAX's row order.  The other
nets name their flax modules in ``FLAX_MODULES`` (the DQN nets'
``Dense_0..1`` or the dueling ``Dense_0..3``, Rainbow's
``NoisyDense_0..3``, the actor-critic family's ``Dense_*``).  A parameter
that is not a torch ``weight``/``bias`` keeps flax's leaf name and layout
(``NoisyLinear``'s ``w_mu``/``b_mu``/``w_sigma``/``b_sigma``, the
Gaussian head's top-level ``log_std``).  The same mapping carries any
per-parameter tensor, such as Adam's moments (``agents/ppo.Optimizer``).
"""

from __future__ import annotations

import math

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


def _flax_path(name: str, net=None) -> tuple:
    """A parameter name of ``net`` -> its path in the flax tree: a
    ``PolicyNet``'s, or the ``FLAX_MODULES`` of a net that has them; a
    name without a module is a top-level flax leaf."""
    if "." not in name:
        return (name,)
    modules = getattr(net, "FLAX_MODULES", _MODULES)
    module, leaf = name.rsplit(".", 1)
    return modules[module] + (_LEAVES.get(leaf, leaf),)


def _to_flax_layout(t: torch.Tensor, name: str) -> np.ndarray:
    """A torch ``weight``: OIHW -> HWIO, ``(out, in)`` -> ``(in, out)``;
    float32 numpy.  Another parameter keeps its layout."""
    a = t.detach().to("cpu", torch.float32).numpy()
    if name.endswith("weight"):
        a = np.transpose(a, (2, 3, 1, 0) if a.ndim == 4 else (1, 0))
    return np.ascontiguousarray(a)


def _from_flax_layout(a, like: torch.Tensor, name: str,
                      param: str) -> torch.Tensor:
    """The inverse of ``_to_flax_layout`` for the port's parameter named
    ``param``, shaped and placed like ``like``; a flax leaf of another
    shape raises."""
    a = np.asarray(a)
    stored = tuple(a.shape)
    if param.endswith("weight"):
        a = np.transpose(a, (3, 2, 0, 1) if a.ndim == 4 else (1, 0))
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
        *outer, leaf = _flax_path(name, net)
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = _to_flax_layout(t, name)
    return {"params": tree}


def tensors_from_flax(net: PolicyNet, tree) -> list:
    """One tensor per ``net.parameters()`` entry from a flax tree, in the
    port's layout on the net's device.  A missing or extra leaf, or one
    of another shape, raises ``ValueError``."""
    p = tree.get("params", tree) if isinstance(tree, dict) else tree
    out, seen = [], set()
    for name, param in net.named_parameters():
        path = _flax_path(name, net)
        node = p
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"flax tree has no {'/'.join(path)}")
            node = node[key]
        out.append(_from_flax_layout(node, param, "/".join(path), name))
        seen.add(path)
    extra = ["/".join(path) for path, _ in flax_leaves(p)
             if path not in seen]
    if extra:
        kind = (type(net).__name__ if not isinstance(net, PolicyNet) else
                "recurrent PolicyNet" if net.recurrent else
                "feed-forward PolicyNet")
        raise ValueError(f"flax tree leaves the {kind} does not have: "
                         f"{extra[:3]}")
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
    ``width_mult``, ``hidden_size``, ``recurrent`` (a ``GRUCore_0``),
    ``frame_stack`` (``Conv_0``'s input channels over 4) and
    ``board_size`` (the square root of the logits' width)."""
    p = params.get("params", params)
    conv0 = np.shape(p["ConvTrunk_0"]["Conv_0"]["kernel"])
    actions = int(np.shape(p["Dense_2"]["kernel"])[-1])
    return dict(width_mult=int(conv0[-1]) // 32,
                hidden_size=int(np.shape(p["Dense_0"]["kernel"])[-1]),
                recurrent="GRUCore_0" in p,
                frame_stack=int(conv0[-2]) // 4,
                board_size=math.isqrt(actions))


def policy_net_from_flax(params, width_mult: int | None = None,
                         hidden_size: int | None = None, device=None,
                         dtype: torch.dtype = torch.float32) -> PolicyNet:
    """Build the port's ``PolicyNet`` from a flax ``PolicyNet`` param tree
    (``conv`` trunk): recurrent where the tree has a ``GRUCore_0``, with
    ``4 x frame_stack`` input channels as ``Conv_0`` stores them, for the
    board its logits' width gives.
    ``width_mult`` and ``hidden_size`` default to the stored ones; given,
    a tree of another capacity raises ``ValueError``."""
    device = resolve_device(device)
    arch = architecture(params)
    b = arch["board_size"]
    net = PolicyNet(num_actions=b * b, board_size=b,
                    hidden_size=hidden_size or arch["hidden_size"],
                    width_mult=width_mult or arch["width_mult"],
                    recurrent=arch["recurrent"],
                    in_channels=4 * arch["frame_stack"], dtype=dtype)
    return load_flax_params(net.to(device), params).eval()
