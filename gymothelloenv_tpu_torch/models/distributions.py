"""Masked categorical action distribution — the port of
``models/distributions.py::MaskedCategorical``.

Semantics kept from the reference:
  * sampling / log-prob over the legal subset == softmax with illegal
    logits at -1e9;
  * an empty legal set gives action 0 and log-prob 0 (model.py:71-74);
  * ``log_prob`` of an illegal action is 0;
  * ``entropy_full`` is the UNMASKED softmax entropy (model.py:178-179).
"""

from __future__ import annotations

import dataclasses

import torch

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
