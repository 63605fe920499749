"""Base distributions and the flow-transformed distribution
(port of ``imagecfgen_tpu/flows/distributions.py``).

Every draw takes a ``torch.Generator`` (or ``None`` for the global one) and
happens on the CPU, then moves to the device of the tensors it meets, so a
seed gives the same numbers on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from .bijectors import Chain

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: float = 0.0
    scale: float = 1.0
    event_shape: Tuple[int, ...] = (1,)

    def sample(self, rng: Optional[torch.Generator], n: int, device=None) -> torch.Tensor:
        u = torch.randn((n, *self.event_shape), generator=rng).to(device)
        return self.loc + self.scale * u

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        lp = -0.5 * (z**2 + LOG_2PI) - math.log(self.scale)
        return lp.reshape(x.shape[0], -1).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float = 0.0
    high: float = 1.0
    event_shape: Tuple[int, ...] = (1,)

    def sample(self, rng: Optional[torch.Generator], n: int, device=None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``n`` draws of U(low, high); ``u`` injects the U(0, 1) draw."""
        if u is None:
            u = torch.rand((n, *self.event_shape), generator=rng)
        return torch.clamp(u.to(device) * (self.high - self.low) + self.low, min=self.low)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``-log(high - low)`` an element inside ``[low, high]``, ``-inf``
        outside, summed over the event."""
        inside = (x >= self.low) & (x <= self.high)
        lp = torch.where(inside, torch.full_like(x, -math.log(self.high - self.low)),
                         torch.full_like(x, -math.inf))
        return lp.reshape(x.shape[0], -1).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class Gumbel:
    """Standard Gumbel(0, 1) — the exogenous noise of categorical
    mechanisms."""

    def sample(self, rng: Optional[torch.Generator], shape, device=None) -> torch.Tensor:
        u = torch.rand(shape, generator=rng).clamp_(min=torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)

    def log_prob(self, g: torch.Tensor) -> torch.Tensor:
        return -(g + torch.exp(-g))


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Categorical over ``n`` classes given a logits tensor."""

    n: int

    def sample(self, rng, logits: torch.Tensor, n_samples: Optional[int] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gumbel-max draw; ``gumbel`` injects the ``(..., n)`` noise."""
        if logits.dim() == 1 and n_samples is not None:
            logits = logits.expand(n_samples, self.n)
        if gumbel is None:
            gumbel = Gumbel().sample(rng, logits.shape, logits.device)
        return torch.argmax(logits + gumbel, dim=-1)

    def log_prob(self, logits: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        value = value.reshape(-1).long()
        if logp.dim() == 1:
            return logp[value]
        return torch.gather(logp, 1, value[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class FlowDist:
    """A base distribution pushed through a chain of bijectors:
    ``X = chain.forward(U)``, ``U ~ base``; ``log_prob`` and abduction run
    the inverse chain."""

    base: Any
    chain: Chain

    @staticmethod
    def create(base, bijectors) -> "FlowDist":
        return FlowDist(base, Chain(tuple(bijectors)))

    def init(self, rng=None):
        return self.chain.init(rng)

    def forward(self, params, u, context=None, state=None, train=False):
        """noise -> data (generation); returns (x, state)."""
        x, _, state = self.chain.forward(params, u, context, state=state, train=train)
        return x, state

    def inverse(self, params, x, context=None, state=None, train=False):
        """data -> noise (abduction); returns (u, state)."""
        u, _, state = self.chain.inverse(params, x, context, state=state, train=train)
        return u, state

    def log_prob(self, params, x, context=None, state=None, train=False):
        u, ld, state = self.chain.inverse(params, x, context, state=state, train=train)
        return self.base.log_prob(u) + ld, state

    def sample(self, params, rng, n, context=None, state=None, train=False,
               device=None, noise: Optional[torch.Tensor] = None):
        """Draw ``n`` values; ``noise`` injects the base draw ``u``."""
        u = self.base.sample(rng, n, device) if noise is None else noise
        x, _, state = self.chain.forward(params, u, context, state=state, train=train)
        return x, state
