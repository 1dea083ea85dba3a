"""Import reference torch checkpoints into the port's nets — the port of
``compat/torch_import.py``.

The reference persists torch modules: ``util.save`` stores
``model_state_dict`` dicts (util.py:9-25), the vectorised drivers
``torch.save`` the whole ``actor_critic`` module
(ppo_run_self_play.py:218-223).  The port's nets are torch modules of the
same architectures, so conversion copies the conv and linear tensors as
they are (OIHW, ``(out, in)``) but for one re-layout: the reference
flattens the trunk's NCHW output in ``(C, H, W)`` order, the port's trunk
in flax's ``(H, W, C)`` order (``models/nets.ConvTrunk``), so the first
linear's input columns are permuted.

Supported: the vendored masked ``Policy`` with CNNBase (model.py:288-314)
-> ``PolicyNet``; ``DQN``/``Dueling_DQN`` (dqn.py:73-127) -> ``DQNNet``/
``DuelingDQNNet``; the standalone PPO ``ActorCritic`` (ppo.py:29-108) ->
``ActorCriticNet``.  ``export_policy_net`` goes back.
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.dqn import featurize3
from gymothelloenv_tpu_torch.models.nets import (ActorCriticNet, DQNNet,
                                                 DuelingDQNNet, PolicyNet,
                                                 trunk_side)
from gymothelloenv_tpu_torch.utils.device import resolve_device

_TRUNK = ("trunk.conv0", "trunk.conv1", "trunk.conv2")


def _t(x) -> torch.Tensor:
    """A torch tensor or array-like -> a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _flatten_perm(h: int, w: int, c: int) -> np.ndarray:
    """Entry ``f`` is the reference's flat index (C, H, W order) feeding
    the port's flat position ``f`` (H, W, C order)."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return idx.transpose(1, 2, 0).reshape(-1)


def _state_dict(obj) -> dict:
    """Normalise ``torch.load`` results: a module, a ``util.save``
    checkpoint dict, or a bare state_dict."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "model_state_dict" in obj:                 # util.py:9-17 layout
        obj = obj["model_state_dict"]
    return dict(obj)


def _load(net: torch.nn.Module, sd: dict, names: dict, flat_in=(),
          device=None) -> torch.nn.Module:
    """Copy ``sd``'s tensors into ``net`` by ``names`` (the reference's
    layer -> the port's), permuting the input columns of the layers in
    ``flat_in``; a missing or misshapen tensor raises."""
    c = net.trunk.conv2.out_channels
    s = trunk_side(getattr(net, "board_size", 8))
    perm = torch.from_numpy(_flatten_perm(s, s, c))
    own = dict(net.named_parameters())
    with torch.no_grad():
        for ref, port in names.items():
            for leaf in ("weight", "bias"):
                src = _t(sd[f"{ref}.{leaf}"])
                if port in flat_in and leaf == "weight":
                    src = src[:, perm]
                dst = own[f"{port}.{leaf}"]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{ref}.{leaf}: shape "
                                     f"{tuple(src.shape)} does not fit "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    return net.to(resolve_device(device)).eval()


def import_policy_net(obj, device=None) -> PolicyNet:
    """The vendored ``Policy`` (base.main convs + critic_linear +
    dist.linear, model.py:288-314) -> ``PolicyNet`` of its width and
    hidden size."""
    sd = _state_dict(obj)
    conv0 = _t(sd["base.main.0.weight"])
    net = PolicyNet(num_actions=int(_t(sd["dist.linear.weight"]).shape[0]),
                    hidden_size=int(_t(sd["base.main.7.weight"]).shape[0]),
                    width_mult=int(conv0.shape[0]) // 32,
                    in_channels=int(conv0.shape[1]))
    names = {"base.main.0": _TRUNK[0], "base.main.2": _TRUNK[1],
             "base.main.4": _TRUNK[2], "base.main.7": "fc",
             "base.critic_linear": "value", "dist.linear": "logits"}
    return _load(net, sd, names, ("fc",), device)


def import_dqn_net(obj, device=None) -> DQNNet:
    """``DQN`` (dqn.py:73-95) -> ``DQNNet``."""
    sd = _state_dict(obj)
    net = DQNNet(num_actions=int(_t(sd["fc5.weight"]).shape[0]))
    names = {"conv1": _TRUNK[0], "conv2": _TRUNK[1], "conv3": _TRUNK[2],
             "fc4": "fc", "fc5": "out"}
    return _load(net, sd, names, ("fc",), device)


def import_dueling_dqn_net(obj, device=None) -> DuelingDQNNet:
    """``Dueling_DQN`` (dqn.py:97-127) -> ``DuelingDQNNet``."""
    sd = _state_dict(obj)
    net = DuelingDQNNet(num_actions=int(_t(sd["fc2_adv.weight"]).shape[0]))
    names = {"conv1": _TRUNK[0], "conv2": _TRUNK[1], "conv3": _TRUNK[2],
             "fc1_adv": "adv_fc", "fc1_val": "val_fc", "fc2_adv": "adv",
             "fc2_val": "val"}
    return _load(net, sd, names, ("adv_fc", "val_fc"), device)


def import_actor_critic(obj, device=None) -> ActorCriticNet:
    """The standalone PPO ``ActorCritic`` (ppo.py:29-108: conv1-3, fc4
    shared, fc5 policy head, fc6 value head) -> ``ActorCriticNet``."""
    sd = _state_dict(obj)
    net = ActorCriticNet(num_actions=int(_t(sd["fc5.weight"]).shape[0]),
                         in_channels=int(_t(sd["conv1.weight"]).shape[1]))
    names = {"conv1": _TRUNK[0], "conv2": _TRUNK[1], "conv3": _TRUNK[2],
             "fc4": "fc", "fc5": "logits", "fc6": "value"}
    return _load(net, sd, names, ("fc",), device)


def load_torch_checkpoint(path: str):
    """``torch.load`` a reference checkpoint file (a whole module or a
    util.save dict) on the CPU, for one of the ``import_*`` functions.
    A pickled module needs the reference's class importable."""
    return torch.load(path, map_location="cpu", weights_only=False)


def export_policy_net(net: PolicyNet) -> dict:
    """The reverse direction: a feed-forward ``PolicyNet`` -> a state_dict
    (numpy values) that the reference's vendored ``Policy``
    (model.py:288-314) loads with ``strict=False``: models trained here go
    back to the original code.  The exact inverse of
    ``import_policy_net``."""
    own = {k: v.detach().cpu().numpy() for k, v in net.named_parameters()}
    c = net.trunk.conv2.out_channels
    s = trunk_side(net.board_size)
    inv = np.argsort(_flatten_perm(s, s, c))
    sd = {}
    for ref, port in (("base.main.0", _TRUNK[0]), ("base.main.2", _TRUNK[1]),
                      ("base.main.4", _TRUNK[2]), ("base.main.7", "fc"),
                      ("base.critic_linear", "value"),
                      ("dist.linear", "logits")):
        w = own[f"{port}.weight"]
        sd[f"{ref}.weight"] = (w[:, inv] if port == "fc" else w).copy()
        sd[f"{ref}.bias"] = own[f"{port}.bias"].copy()
    return sd


def detect_and_import(obj, device=None):
    """Identify which reference architecture a checkpoint holds (by its
    state_dict keys) and convert it.  Returns ``(kind, net)`` with kind in
    {'policy', 'actor_critic', 'dueling_dqn', 'dqn'}."""
    sd = _state_dict(obj)
    if "base.main.0.weight" in sd:
        return "policy", import_policy_net(sd, device)
    if "fc1_adv.weight" in sd:
        return "dueling_dqn", import_dueling_dqn_net(sd, device)
    if "fc6.weight" in sd:
        return "actor_critic", import_actor_critic(sd, device)
    if "fc5.weight" in sd:
        return "dqn", import_dqn_net(sd, device)
    raise ValueError(
        "unrecognized checkpoint layout; keys: "
        + ", ".join(sorted(sd)[:8]) + " ...")


class QPolicy(torch.nn.Module):
    """A DQN-family net as a policy over the 4-plane ``make_state``
    input (JAX ``imported_apply_fn``'s q_apply): board and turn recovered
    from the planes, refeaturised to the net's 3 planes, the Q values
    times 1e6 as near-deterministic logits (greedy over the legal Q,
    dqn.py:478-488) and a zero value."""

    def __init__(self, q_net: torch.nn.Module):
        super().__init__()
        self.q_net = q_net

    def forward(self, obs: torch.Tensor):
        board = (obs[:, 1] - obs[:, 0]).to(torch.int8)
        turn = (obs[:, 2, 0, 0] * 2 - 1).to(torch.int8)
        q = self.q_net(featurize3(board, turn))
        return q * 1e6, torch.zeros(obs.shape[0], device=obs.device)


def imported_policy(kind: str, net: torch.nn.Module) -> torch.nn.Module:
    """A ``detect_and_import`` result as a policy ``net(obs4) -> (logits,
    value)`` for the tournament and the evaluation CLI: the policy and
    actor-critic nets as they are, the DQN kinds through ``QPolicy``."""
    if kind in ("policy", "actor_critic"):
        return net
    if kind in ("dqn", "dueling_dqn"):
        return QPolicy(net).eval()
    raise ValueError(f"unknown checkpoint kind: {kind}")
