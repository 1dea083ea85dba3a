"""Action distributions — the port of ``models/distributions.py``: the
masked categorical of the board games, and ``DiagNormal``/
``BernoulliDist`` (the vendored ``FixedNormal``/``FixedBernoulli``,
distributions.py:36-57) of the actor-critic family's continuous and binary
heads, whose log-probs and entropies sum over the action dimension.

The masked categorical keeps the reference's semantics:
  * sampling / log-prob over the legal subset == softmax with illegal
    logits at -1e9;
  * an empty legal set gives action 0 and log-prob 0 (model.py:71-74);
  * ``log_prob`` of an illegal action is 0;
  * ``entropy_full`` is the UNMASKED softmax entropy (model.py:178-179).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

_NEG_INF = -1e9


@dataclasses.dataclass
class MaskedCategorical:
    logits: torch.Tensor  # (..., A) raw network outputs
    mask: torch.Tensor    # bool (..., A) legal actions

    @property
    def any_legal(self) -> torch.Tensor:
        return self.mask.any(dim=-1)

    @property
    def masked_logits(self) -> torch.Tensor:
        return torch.where(self.mask, self.logits,
                           torch.full_like(self.logits, _NEG_INF))

    def sample(self, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Inverse-CDF draw: ``action = count(cumsum(w) < u * total)`` with
        ``u`` in (0, 1] given, or ``1 - uniform[0, 1)`` from
        ``generator``.  Since ``u * total > 0`` the count lands on a legal
        action.  int64 actions."""
        ml = self.masked_logits
        w = torch.exp(ml - ml.max(dim=-1, keepdim=True).values)
        w = torch.where(self.mask, w, torch.zeros_like(w))
        c = torch.cumsum(w, dim=-1)
        if u is None:
            u = 1.0 - torch.rand(ml.shape[:-1], generator=generator,
                                 device=ml.device, dtype=c.dtype)
        t = u.to(c.dtype)[..., None] * c[..., -1:]
        action = (c < t).sum(dim=-1)
        return torch.where(self.any_legal, action, torch.zeros_like(action))

    def mode(self) -> torch.Tensor:
        action = torch.argmax(self.masked_logits, dim=-1)
        return torch.where(self.any_legal, action, torch.zeros_like(action))

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        """Log-prob under the legal-subset softmax; 0 when the legal set is
        empty or the action is illegal (or out of range)."""
        a = self.logits.shape[-1]
        onehot = action[..., None].to(torch.int64) == torch.arange(
            a, device=self.logits.device)
        logp_all = torch.log_softmax(self.masked_logits, dim=-1)
        logp = torch.where(onehot, logp_all,
                           torch.zeros_like(logp_all)).sum(dim=-1)
        legal_action = (onehot & self.mask).any(dim=-1)
        return torch.where(self.any_legal & legal_action, logp,
                           torch.zeros_like(logp))

    def entropy_full(self) -> torch.Tensor:
        """Entropy of the unmasked softmax (reference entropy bonus)."""
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(dim=-1)


_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class DiagNormal:
    """Independent Gaussian per action dimension (FixedNormal,
    distributions.py:36-44; JAX ``DiagNormal``): ``log_prob``/``entropy``
    sum over the last dimension, ``mode`` is the mean."""
    mean: torch.Tensor     # (..., D)
    log_std: torch.Tensor  # (..., D) or broadcastable

    def sample(self, eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """``mean + exp(log_std) * eps``, ``eps`` standard normals shaped
        like the mean, given or drawn from ``generator``."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_std) * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        z = (actions - self.mean) * torch.exp(-self.log_std)
        per_dim = -0.5 * (z ** 2) - self.log_std - 0.5 * _LOG_2PI
        return per_dim.sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        per_dim = 0.5 + 0.5 * _LOG_2PI + self.log_std
        return per_dim.expand_as(self.mean).sum(dim=-1)


@dataclasses.dataclass
class BernoulliDist:
    """Independent Bernoulli per output bit (FixedBernoulli,
    distributions.py:48-57; JAX ``BernoulliDist``): ``log_prob``/
    ``entropy`` sum over the last dimension, ``mode`` thresholds the
    probabilities at 0.5."""
    logits: torch.Tensor   # (..., D)

    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def sample(self, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """float32 bits ``u < probs`` (``jax.random.bernoulli``), ``u``
        uniforms in [0, 1) shaped like the logits, given or drawn from
        ``generator``."""
        p = self.probs()
        if u is None:
            u = torch.rand(p.shape, generator=generator, device=p.device,
                           dtype=p.dtype)
        return (u < p).to(torch.float32)

    def mode(self) -> torch.Tensor:
        return (self.probs() > 0.5).to(torch.float32)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        per_dim = (actions * F.logsigmoid(self.logits)
                   + (1.0 - actions) * F.logsigmoid(-self.logits))
        return per_dim.sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        p = self.probs()
        per_dim = (F.softplus(-self.logits) * p
                   + F.softplus(self.logits) * (1.0 - p))
        return per_dim.sum(dim=-1)
