"""Normalizing-flow bijectors as plain functions on tensors
(port of ``imagecfgen_tpu/flows/bijectors.py``).

API (uniform across bijectors)::

    params, state = bij.init(rng)            # rng: torch.Generator or None
    y, logdet, state = bij.forward(params, x, context, state=state, train=...)
    x, logdet, state = bij.inverse(params, y, context, state=state, train=...)

- ``forward`` maps base noise toward data; ``inverse`` maps data toward
  noise (the direction of ``log_prob`` and of counterfactual abduction).
- ``logdet`` is the per-sample summed log|d out/d in|, shape ``(B,)``.
- ``params``/``state`` are dicts, lists and tuples of tensors with the same
  structure as the JAX package's pytrees, so they carry across leaf by leaf.
  ``init`` makes them on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Any
State = Any


def _sum_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum all but the leading (batch) axis."""
    return x.reshape(x.shape[0], -1).sum(dim=1)


def _normal(rng: Optional[torch.Generator], shape) -> torch.Tensor:
    return torch.randn(shape, generator=rng)


class Bijector:
    def init(self, rng: Optional[torch.Generator] = None) -> Tuple[Params, State]:
        return {}, {}

    def forward(self, params, x, context=None, state=None, train=False):
        raise NotImplementedError

    def inverse(self, params, y, context=None, state=None, train=False):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AffineT(Bijector):
    """y = loc + scale * x with static loc/scale."""

    loc: float
    scale: float

    def _logdet(self, x, sign):
        n = x[0].numel() if x.dim() > 1 else 1
        ld = sign * math.log(abs(float(self.scale)))
        return torch.full((x.shape[0],), ld, dtype=torch.float32, device=x.device) * n

    def forward(self, params, x, context=None, state=None, train=False):
        return self.loc + self.scale * x, self._logdet(x, 1.0), state

    def inverse(self, params, y, context=None, state=None, train=False):
        return (y - self.loc) / self.scale, self._logdet(y, -1.0), state


@dataclasses.dataclass(frozen=True)
class ExpT(Bijector):
    """y = exp(x)."""

    def forward(self, params, x, context=None, state=None, train=False):
        return torch.exp(x), _sum_batch(x), state

    def inverse(self, params, y, context=None, state=None, train=False):
        x = torch.log(y)
        return x, _sum_batch(-x), state


@dataclasses.dataclass(frozen=True)
class SigmoidT(Bijector):
    """y = sigmoid(x)."""

    def forward(self, params, x, context=None, state=None, train=False):
        ld = _sum_batch(-F.softplus(x) - F.softplus(-x))
        return torch.sigmoid(x), ld, state

    def inverse(self, params, y, context=None, state=None, train=False):
        y = torch.clamp(y, 1e-7, 1 - 1e-7)
        x = torch.log(y) - torch.log1p(-y)
        return x, _sum_batch(-torch.log(y) - torch.log1p(-y)), state


@dataclasses.dataclass(frozen=True)
class BatchNormFlow(Bijector):
    """Batch-norm bijector with pyro's train/eval asymmetry: ``inverse``
    normalizes with batch statistics when ``train`` (returning updated
    running statistics) and with the running statistics otherwise;
    ``forward`` always de-normalizes with the running statistics."""

    dim: int = 1
    momentum: float = 0.1
    eps: float = 1e-5

    def init(self, rng=None):
        params = {"log_gamma": torch.zeros(self.dim), "beta": torch.zeros(self.dim)}
        state = {"mean": torch.zeros(self.dim), "var": torch.ones(self.dim)}
        return params, state

    def forward(self, params, x, context=None, state=None, train=False):
        gamma = torch.exp(params["log_gamma"])
        std = torch.sqrt(state["var"] + self.eps)
        y = (x - params["beta"]) / gamma * std + state["mean"]
        ld = _sum_batch((torch.log(std) - params["log_gamma"]).expand(x.shape))
        return y, ld, state

    def inverse(self, params, y, context=None, state=None, train=False):
        gamma = torch.exp(params["log_gamma"])
        if train:
            mean = y.mean(dim=0)
            var = y.var(dim=0, unbiased=False)
            new_state = {
                "mean": (1 - self.momentum) * state["mean"] + self.momentum * mean,
                "var": (1 - self.momentum) * state["var"] + self.momentum * var,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        std = torch.sqrt(var + self.eps)
        x = (y - mean) / std * gamma + params["beta"]
        ld = _sum_batch((params["log_gamma"] - torch.log(std)).expand(y.shape))
        return x, ld, new_state


def _mlp_init(rng, sizes):
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = _normal(rng, (n_in, n_out)) * math.sqrt(1.0 / n_in)
        params.append({"w": w, "b": torch.zeros(n_out)})
    return params


def _mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


@dataclasses.dataclass(frozen=True)
class ConditionalAffineT(Bijector):
    """Context-conditioned affine: y = loc(ctx) + exp(clip(s(ctx))) * x, an
    MLP from the context to (loc, log_scale), log-scale clipped as pyro's
    AffineAutoregressive clips it."""

    context_dim: int = 1
    event_dim: int = 1
    hidden: Tuple[int, ...] = (32, 32)
    log_scale_clip: Tuple[float, float] = (-5.0, 3.0)

    def init(self, rng=None):
        sizes = (self.context_dim, *self.hidden, 2 * self.event_dim)
        return {"mlp": _mlp_init(rng, sizes)}, {}

    def _loc_scale(self, params, context):
        loc, log_scale = torch.chunk(_mlp_apply(params["mlp"], context), 2, dim=-1)
        return loc, torch.clamp(log_scale, *self.log_scale_clip)

    def forward(self, params, x, context=None, state=None, train=False):
        loc, log_scale = self._loc_scale(params, context)
        y = loc + torch.exp(log_scale) * x
        return y, _sum_batch(log_scale.expand(x.shape)), state

    def inverse(self, params, y, context=None, state=None, train=False):
        loc, log_scale = self._loc_scale(params, context)
        x = (y - loc) * torch.exp(-log_scale)
        return x, _sum_batch((-log_scale).expand(y.shape)), state


def _cum_knots(v: torch.Tensor, bound: float) -> torch.Tensor:
    """(dim, K) bin sizes -> (dim, K+1) knot positions in [-bound, bound]."""
    zero = torch.zeros(v.shape[0], 1, dtype=v.dtype, device=v.device)
    return torch.cat([zero, torch.cumsum(v, dim=-1)], dim=-1) * 2 * bound - bound


def _spline_bins(knots: torch.Tensor, v: torch.Tensor, count_bins: int) -> torch.Tensor:
    """Bin of each (B, dim) value against (dim, K+1) knots:
    ``searchsorted(side="right") - 1``, clipped to the bins."""
    idx = torch.searchsorted(knots.contiguous(), v.t().contiguous(), right=True).t() - 1
    return torch.clamp(idx, 0, count_bins - 1)


def _take(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl (dim, K+1), idx (B, dim) -> tbl[d, idx[b, d]] as (B, dim)."""
    return torch.gather(tbl.t(), 0, idx)


class _SplineBase(Bijector):
    dim: int
    count_bins: int
    bound: float
    min_bin: float
    min_deriv: float

    def _common_knots(self, params):
        w = torch.softmax(params["widths"], dim=-1)
        h = torch.softmax(params["heights"], dim=-1)
        w = self.min_bin + (1 - self.min_bin * self.count_bins) * w
        h = self.min_bin + (1 - self.min_bin * self.count_bins) * h
        cw, ch = _cum_knots(w, self.bound), _cum_knots(h, self.bound)
        d = self.min_deriv + F.softplus(params["derivs"])
        # boundary derivatives fixed to 1 for a C0 match with identity tails
        ones = torch.ones(self.dim, 1, dtype=d.dtype, device=d.device)
        return cw, ch, torch.cat([ones, d, ones], dim=-1)

    def _apply(self, params, v, inverse):
        raise NotImplementedError

    def forward(self, params, x, context=None, state=None, train=False):
        squeeze = x.dim() == 1
        y, ld = self._apply(params, x[:, None] if squeeze else x, inverse=False)
        return (y[:, 0] if squeeze else y), _sum_batch(ld), state

    def inverse(self, params, y, context=None, state=None, train=False):
        squeeze = y.dim() == 1
        x, ld = self._apply(params, y[:, None] if squeeze else y, inverse=True)
        return (x[:, 0] if squeeze else x), _sum_batch(ld), state


@dataclasses.dataclass(frozen=True)
class SplineT(_SplineBase):
    """Element-wise monotone rational-quadratic spline (Durkan et al. 2019),
    identity tails outside [-bound, bound]."""

    dim: int = 1
    count_bins: int = 8
    bound: float = 3.0
    min_bin: float = 1e-3
    min_deriv: float = 1e-3

    def init(self, rng=None):
        params = {
            "widths": 1e-2 * _normal(rng, (self.dim, self.count_bins)),
            "heights": 1e-2 * _normal(rng, (self.dim, self.count_bins)),
            "derivs": 1e-2 * _normal(rng, (self.dim, self.count_bins - 1)),
        }
        return params, {}

    def _apply(self, params, v, inverse):
        cw, ch, d = self._common_knots(params)
        B = self.bound
        inside = (v > -B) & (v < B)
        v_in = torch.clamp(v, -B + 1e-6, B - 1e-6)
        idx = _spline_bins(ch if inverse else cw, v_in, self.count_bins)

        xk, xk1 = _take(cw, idx), _take(cw, idx + 1)
        yk, yk1 = _take(ch, idx), _take(ch, idx + 1)
        dk, dk1 = _take(d, idx), _take(d, idx + 1)
        wbin = xk1 - xk
        hbin = yk1 - yk
        s = hbin / wbin

        if not inverse:
            xi = (v_in - xk) / wbin
            num = hbin * (s * xi**2 + dk * xi * (1 - xi))
            den = s + (dk1 + dk - 2 * s) * xi * (1 - xi)
            out = yk + num / den
            dnum = s**2 * (dk1 * xi**2 + 2 * s * xi * (1 - xi) + dk * (1 - xi) ** 2)
            logdet = torch.log(dnum) - 2 * torch.log(den)
        else:
            # solve the quadratic for xi given y
            t = v_in - yk
            a = hbin * (s - dk) + t * (dk1 + dk - 2 * s)
            b = hbin * dk - t * (dk1 + dk - 2 * s)
            c = -s * t
            disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
            xi = torch.clamp(2 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
            out = xk + xi * wbin
            den = s + (dk1 + dk - 2 * s) * xi * (1 - xi)
            dnum = s**2 * (dk1 * xi**2 + 2 * s * xi * (1 - xi) + dk * (1 - xi) ** 2)
            logdet = -(torch.log(dnum) - 2 * torch.log(den))

        out = torch.where(inside, out, v)
        logdet = torch.where(inside, logdet, torch.zeros_like(logdet))
        return out, logdet


@dataclasses.dataclass(frozen=True)
class LinearRationalSplineT(_SplineBase):
    """Element-wise monotone *linear*-rational spline (Dolatabadi et al.
    2020), identity tails outside [-bound, bound]; each bin splits at
    ``lambda = 0.025 + 0.95 * sigmoid(lambdas)`` into two segments with
    weights ``w_a = 1``, ``w_b = sqrt(d_k / d_{k+1})``."""

    dim: int = 1
    count_bins: int = 8
    bound: float = 3.0
    min_bin: float = 1e-3
    min_deriv: float = 1e-3

    def init(self, rng=None):
        params = {
            "widths": 1e-2 * _normal(rng, (self.dim, self.count_bins)),
            "heights": 1e-2 * _normal(rng, (self.dim, self.count_bins)),
            "derivs": 1e-2 * _normal(rng, (self.dim, self.count_bins - 1)),
            "lambdas": 1e-2 * _normal(rng, (self.dim, self.count_bins)),
        }
        return params, {}

    def _apply(self, params, v, inverse):
        cw, ch, d = self._common_knots(params)
        lam = 0.025 + 0.95 * torch.sigmoid(params["lambdas"])  # (dim, K)
        B = self.bound
        inside = (v > -B) & (v < B)
        v_in = torch.clamp(v, -B + 1e-6, B - 1e-6)
        idx = _spline_bins(ch if inverse else cw, v_in, self.count_bins)

        xk, xk1 = _take(cw, idx), _take(cw, idx + 1)
        yk, yk1 = _take(ch, idx), _take(ch, idx + 1)
        dk, dk1 = _take(d, idx), _take(d, idx + 1)
        lm = _take(lam, idx)
        wbin = xk1 - xk
        hbin = yk1 - yk
        s = hbin / wbin

        wa = 1.0
        wb = torch.sqrt(dk / dk1) * wa
        wc = (lm * wa * dk + (1 - lm) * wb * dk1) / s
        yc = ((1 - lm) * wa * yk + lm * wb * yk1) / ((1 - lm) * wa + lm * wb)

        if not inverse:
            theta = (v_in - xk) / wbin
            left = theta <= lm
        else:
            y = v_in
            left = y <= yc
            theta = torch.where(
                left,
                wa * lm * (y - yk) / (wc * yc - wa * yk - y * (wc - wa)),
                (wc * yc - lm * wb * yk1 - y * (wc - lm * wb))
                / (wc * yc - wb * yk1 - y * (wc - wb)),
            )
            theta = torch.clamp(theta, 0.0, 1.0)
        den = torch.where(
            left, wa * (lm - theta) + wc * theta, wc * (1 - theta) + wb * (theta - lm)
        )
        dnum = torch.where(left, wa * wc * lm * (yc - yk), wb * wc * (1 - lm) * (yk1 - yc))
        # dy/dx = dnum / den^2 / wbin
        logdet = torch.log(dnum) - 2 * torch.log(torch.abs(den)) - torch.log(wbin)
        if not inverse:
            num = torch.where(
                left,
                wa * yk * (lm - theta) + wc * yc * theta,
                wc * yc * (1 - theta) + wb * yk1 * (theta - lm),
            )
            out = num / den
        else:
            out = xk + theta * wbin
            logdet = -logdet

        out = torch.where(inside, out, v)
        logdet = torch.where(inside, logdet, torch.zeros_like(logdet))
        return out, logdet


@dataclasses.dataclass(frozen=True)
class Chain(Bijector):
    """Composition: forward applies bijectors in order (base -> data)."""

    bijectors: Tuple[Bijector, ...]

    def init(self, rng=None):
        ps, ss = [], []
        for b in self.bijectors:
            p, s = b.init(rng)
            ps.append(p)
            ss.append(s)
        return tuple(ps), tuple(ss)

    def forward(self, params, x, context=None, state=None, train=False):
        total = torch.zeros(x.shape[0], device=x.device)
        new_state = []
        for b, p, s in zip(self.bijectors, params, state):
            x, ld, s = b.forward(p, x, context, state=s, train=train)
            total = total + ld
            new_state.append(s)
        return x, total, tuple(new_state)

    def inverse(self, params, y, context=None, state=None, train=False):
        total = torch.zeros(y.shape[0], device=y.device)
        new_state = [None] * len(self.bijectors)
        for i in reversed(range(len(self.bijectors))):
            y, ld, s = self.bijectors[i].inverse(params[i], y, context, state=state[i], train=train)
            total = total + ld
            new_state[i] = s
        return y, total, tuple(new_state)
