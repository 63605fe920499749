"""Causal mechanisms (structural-equation modules)
(port of ``imagecfgen_tpu/scm/module.py``).

Every mechanism supports ``recover_noise`` (abduction), ``generate`` (the
structural map noise -> value), ``log_prob`` and ``sample``, as functions
of explicit ``(params, state)`` trees.

Value conventions: continuous node values are ``(B, 1)`` float; categorical
node values are ``(B,)`` int64. Parent values arrive as one context tensor
assembled by the graph (one-hot for categorical parents).

``sample`` and ``recover_noise`` take a ``torch.Generator`` and ``noise``:
the exogenous draw to use instead (the base ``u`` of a flow, the Gumbels of
a categorical), so that tests can hand both packages the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..flows.bijectors import _mlp_apply, _mlp_init
from ..flows.distributions import Categorical, FlowDist, Gumbel


class CausalModule:
    #: whether values are int-coded categories
    categorical: bool = False
    n_categories: int = 0

    def init(self, rng=None) -> Tuple[Any, Any]:
        raise NotImplementedError

    def recover_noise(self, params, state, rng, value, context, noise=None) -> torch.Tensor:
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

    def recover_noise(self, params, state, rng, value, context, noise=None):
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

    @staticmethod
    def fit_params(values: torch.Tensor, n: int):
        """Empirical-frequency MLE from int-coded observations."""
        counts = torch.bincount(values.reshape(-1).long(), minlength=n).float()
        probs = counts / counts.sum()
        return {"logits": torch.log(torch.clamp(probs, min=1e-12))}

    def recover_noise(self, params, state, rng, value, context, noise=None):
        return value

    def generate(self, params, state, noise, context):
        return noise

    def log_prob(self, params, state, value, context, train=False):
        return Categorical(self.n).log_prob(params["logits"], value), state

    def sample(self, params, state, rng, context, n, device=None, noise=None):
        return Categorical(self.n).sample(rng, params["logits"], n, gumbel=noise)


@dataclasses.dataclass(frozen=True)
class ConditionalCategoricalCM(CausalModule):
    """Categorical mechanism with MLP logits and Gumbel-max counterfactuals.

    ``generate(noise, ctx) = argmax(logits(ctx) + noise)`` with Gumbel noise;
    ``recover_noise`` draws from the *posterior* over the Gumbels given the
    observed class: the observed class receives the max, all others are
    truncated below it (the JAX package's formula).
    """

    n: int
    context_dim: int
    hidden: Tuple[int, ...] = (64, 64)

    @property
    def categorical(self):
        return True

    @property
    def n_categories(self):
        return self.n

    def init(self, rng=None):
        return {"mlp": _mlp_init(rng, (self.context_dim, *self.hidden, self.n))}, {}

    def logits(self, params, context):
        return _mlp_apply(params["mlp"], context)

    def recover_noise(self, params, state, rng, value, context, noise=None):
        """``noise``: the ``(B, n)`` prior Gumbels to condition (drawn from
        ``rng`` when None)."""
        logits = self.logits(params, context)
        y = value.reshape(-1, 1).long()
        g = Gumbel().sample(rng, logits.shape, logits.device) if noise is None else noise
        gk = torch.gather(g, 1, y)
        logits_k = torch.gather(logits, 1, y)
        # max value of logits + noise, shifted to the observed class
        noise_k = gk + torch.logsumexp(logits, dim=1, keepdim=True) - logits_k
        # remaining classes: Gumbels truncated below the observed max
        noise_l = -torch.log(torch.exp(-g - logits) + torch.exp(-gk - logits_k)) - logits
        onehot = F.one_hot(y[:, 0], self.n).to(logits.dtype)
        return onehot * noise_k + (1.0 - onehot) * noise_l

    def generate(self, params, state, noise, context):
        return torch.argmax(self.logits(params, context) + noise, dim=1)

    def log_prob(self, params, state, value, context, train=False):
        return Categorical(self.n).log_prob(self.logits(params, context), value), state

    def sample(self, params, state, rng, context, n, device=None, noise=None):
        return Categorical(self.n).sample(rng, self.logits(params, context), gumbel=noise)
