"""Causal mechanisms (structural-equation modules)
(port of ``imagecfgen_tpu/scm/module.py``).

Every mechanism supports ``recover_noise`` (abduction), ``generate`` (the
structural map noise -> value), ``log_prob`` and ``sample``, as functions
of explicit ``(params, state)`` trees.

Value conventions: continuous node values are ``(B, 1)`` float; categorical
node values are ``(B,)`` int64. Parent values arrive as one context tensor
assembled by the graph (one-hot for categorical parents).

``sample`` takes a ``torch.Generator`` and, for tests, ``noise``: the
exogenous draw to use instead (the base ``u`` of a flow, the Gumbels of a
categorical).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..flows.distributions import Categorical, FlowDist


class CausalModule:
    #: whether values are int-coded categories
    categorical: bool = False
    n_categories: int = 0

    def init(self, rng=None) -> Tuple[Any, Any]:
        raise NotImplementedError

    def recover_noise(self, params, state, rng, value, context) -> torch.Tensor:
        raise NotImplementedError

    def generate(self, params, state, noise, context) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, params, state, value, context, train=False):
        raise NotImplementedError

    def sample(self, params, state, rng, context, n, device=None, noise=None) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FlowCM(CausalModule):
    """Continuous mechanism: value = flow.forward(noise | context);
    abduction is the inverse flow. An unconditional node ignores the
    context."""

    flow: FlowDist
    conditional: bool = False

    def init(self, rng=None):
        return self.flow.init(rng)

    def _ctx(self, context):
        return context if self.conditional else None

    def recover_noise(self, params, state, rng, value, context):
        u, _ = self.flow.inverse(params, value, self._ctx(context), state=state)
        return u

    def generate(self, params, state, noise, context):
        x, _ = self.flow.forward(params, noise, self._ctx(context), state=state)
        return x

    def log_prob(self, params, state, value, context, train=False):
        return self.flow.log_prob(params, value, self._ctx(context), state=state, train=train)

    def sample(self, params, state, rng, context, n, device=None, noise=None):
        x, _ = self.flow.sample(
            params, rng, n, self._ctx(context), state=state, device=device, noise=noise
        )
        return x


@dataclasses.dataclass(frozen=True)
class CategoricalCM(CausalModule):
    """Root categorical fit by MLE (empirical frequencies): the noise *is*
    the observation."""

    n: int

    @property
    def categorical(self):
        return True

    @property
    def n_categories(self):
        return self.n

    def init(self, rng=None):
        return {"logits": torch.zeros(self.n)}, {}

    def recover_noise(self, params, state, rng, value, context):
        return value

    def generate(self, params, state, noise, context):
        return noise

    def log_prob(self, params, state, value, context, train=False):
        return Categorical(self.n).log_prob(params["logits"], value), state

    def sample(self, params, state, rng, context, n, device=None, noise=None):
        return Categorical(self.n).sample(rng, params["logits"], n, gumbel=noise)
