"""Pixel-space baseline explainers: Wachter counterfactuals and the CEM
pertinent negative and positive (port of ``imagecfgen_tpu/cf/baselines.py``,
the JAX package's own from-scratch versions of the two OmnixAI explainers
its scripts compare with).

- :meth:`PixelBaselineExplainers.counterfactual` (Wachter et al.): gradient
  steps on an image ``x'`` that the classifier labels differently from
  ``x`` while staying L1-close to it, for each attack weight ``c``.
- :meth:`PixelBaselineExplainers.contrastive` (CEM, Dhurandhar et al.
  2018), optimised with FISTA (momentum ``k / (k + 3)``): a pertinent
  negative ``pn = x + delta`` (a minimal elastic-net addition that flips the
  label) and a pertinent positive ``pp`` (a minimal part of ``x`` that alone
  keeps it).

The JAX package ``vmap``s the ladder ``c_values`` as a lane axis. Here the
ladder is folded into the batch: ``(C * N, H, W, C_img)``, lane-major (row
``c * N + n``). This is exact: each row's loss is summed on its own and its
gradient reaches that row alone, since the classifier has no op that couples
rows in eval mode. Every step carries the best-so-far candidate of each row,
and the answer is each example's cheapest success over the whole (c, step)
grid; an example no lane explains comes back as ``x`` with ``ok`` False.
Steps run in a Python loop (the JAX package's ``lax.fori_loop``).

Subgradients follow JAX: the L1 terms that are differentiated use
``cf.explain.l1_abs`` (+1 at 0, where ``torch.abs`` gives 0: Wachter starts
at ``x``, so every pixel sits at 0 on its first step), and the hinges use
``torch.maximum`` against 0, whose gradient at a tie is 0.5 as
``jnp.maximum``'s is (``torch.relu`` and ``clamp`` give 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .explain import l1_abs


def _margin_from(logits: torch.Tensor, orig: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score of the original class, best score among the others)."""
    onehot = F.one_hot(orig, logits.shape[-1]).to(logits.dtype)
    return (logits * onehot).sum(-1), (logits - 1e9 * onehot).amax(-1)


def _hinge(v: torch.Tensor) -> torch.Tensor:
    """``max(v, 0)`` with the gradient 0.5 at a tie (``jnp.maximum``'s)."""
    return torch.maximum(v, torch.zeros_like(v))


def _shrink(z: torch.Tensor, thresh: float) -> torch.Tensor:
    """Elementwise soft-threshold (the L1 proximal operator)."""
    return torch.sign(z) * _hinge(z.abs() - thresh)


def _rows(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row vector shaped to broadcast over an image batch."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


@dataclasses.dataclass
class PixelBaselineExplainers:
    """``classify_fn`` maps images (N, H, W, C) to logits (N, K); ``bounds``
    is the valid pixel range (the scripts pass images in [-1, 1]);
    ``c_values`` is the attack-weight ladder, run side by side."""

    classify_fn: Callable[[torch.Tensor], torch.Tensor]
    bounds: Tuple[float, float] = (-1.0, 1.0)
    kappa: float = 0.0
    beta: float = 0.1
    steps: int = 300
    lr: float = 0.05
    c_values: Tuple[float, ...] = (0.1, 1.0, 10.0, 100.0, 1000.0)

    def _ladder(self, x: torch.Tensor):
        """(original labels, the ladder's weight of each folded row, x
        folded C times)."""
        with torch.no_grad():
            orig = torch.argmax(self.classify_fn(x), dim=-1)
        n_c = len(self.c_values)
        cs = torch.tensor(self.c_values, dtype=torch.float32, device=x.device)
        return orig.repeat(n_c), cs.repeat_interleave(x.shape[0]), x.repeat(n_c, *(1,) * (x.dim() - 1))

    def _pick(self, bests: torch.Tensor, dists: torch.Tensor, n: int):
        """Each example's cheapest lane: (that lane's best, ok)."""
        bests = bests.reshape(len(self.c_values), n, *bests.shape[1:])
        dists = dists.reshape(len(self.c_values), n)
        pick = torch.argmin(dists, dim=0)
        out = bests[pick, torch.arange(n, device=bests.device)]
        return out, torch.isfinite(dists.min(dim=0).values)

    # ------------------------------------------------------------------
    # Wachter-style counterfactual (the reference's omnixai "cf" column)
    # ------------------------------------------------------------------
    def counterfactual(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Minimal-L1 label-flipping images: ``(cf, ok)``."""
        lo, hi = self.bounds
        n = x.shape[0]
        orig, c_rows, xs = self._ladder(x)

        def l1(xp):
            return l1_abs(xp - xs).reshape(xp.shape[0], -1).sum(-1)

        xp, best = xs.clone(), xs.clone()
        best_l1 = torch.full((xs.shape[0],), float("inf"), device=x.device)
        for _ in range(self.steps):
            xg = xp.detach().requires_grad_(True)
            f_orig, f_other = _margin_from(self.classify_fn(xg), orig)
            loss = (c_rows * _hinge(f_orig - f_other + self.kappa) + l1(xg)).sum()
            (grad,) = torch.autograd.grad(loss, xg)
            with torch.no_grad():
                xp = torch.clamp(xp - self.lr * grad, lo, hi)
                dist = l1(xp)
                better = (torch.argmax(self.classify_fn(xp), -1) != orig) & (dist < best_l1)
                best = torch.where(_rows(better, x.dim()), xp, best)
                best_l1 = torch.where(better, dist, best_l1)
        cf, ok = self._pick(best, best_l1, n)
        return torch.where(_rows(ok, x.dim()), cf, x), ok

    # ------------------------------------------------------------------
    # CEM pertinent negative / positive (the reference's "pn" / "pp")
    # ------------------------------------------------------------------
    def _fista(self, smooth, start: torch.Tensor, project, keep) -> Tuple[torch.Tensor, torch.Tensor]:
        """FISTA on ``smooth`` (differentiated) + ``beta * |d|_1`` (by its
        proximal step), ``project`` after each step; ``keep(d)`` says which
        rows explain their example. Returns each row's best ``d`` and its
        elastic-net distance (inf where none explained)."""
        n = start.shape[0]

        def elastic(d):
            flat = d.reshape(n, -1)
            return self.beta * flat.abs().sum(-1) + (flat ** 2).sum(-1)

        d, y, best = start.clone(), start.clone(), start.clone()
        best_dist = torch.full((n,), float("inf"), device=start.device)
        for k in range(self.steps):
            yg = y.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(smooth(yg), yg)
            with torch.no_grad():
                d_new = project(_shrink(y - self.lr * grad, self.lr * self.beta))
                y = d_new + (k / (k + 3.0)) * (d_new - d)
                dist = elastic(d_new)
                better = keep(d_new) & (dist < best_dist)
                best = torch.where(_rows(better, start.dim()), d_new, best)
                best_dist = torch.where(better, dist, best_dist)
                d = d_new
        return best, best_dist

    def contrastive(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """CEM explanation: ``(pn, pn_ok, pp, pp_ok)``."""
        lo, hi = self.bounds
        n, nd = x.shape[0], x.dim()
        orig, c_rows, xs = self._ladder(x)

        def sq(d):
            return (d.reshape(d.shape[0], -1) ** 2).sum(-1)

        # -------- pertinent negative: x + delta flips the label --------
        def pn_smooth(d):
            f_orig, f_other = _margin_from(self.classify_fn(xs + d), orig)
            return (c_rows * _hinge(f_orig - f_other + self.kappa) + sq(d)).sum()

        pn_lo, pn_hi = lo - xs, hi - xs  # keep x + d in range
        pn_best, pn_dist = self._fista(
            pn_smooth, torch.zeros_like(xs), lambda d: torch.clamp(d, pn_lo, pn_hi),
            lambda d: torch.argmax(self.classify_fn(xs + d), -1) != orig)

        # ---- pertinent positive: delta alone keeps the label, d "in" x ----
        def pp_smooth(d):
            f_orig, f_other = _margin_from(self.classify_fn(d), orig)
            return (c_rows * _hinge(f_other - f_orig + self.kappa) + sq(d)).sum()

        d_lo, d_hi = torch.clamp(xs, max=0.0), torch.clamp(xs, min=0.0)
        pp_best, pp_dist = self._fista(
            pp_smooth, xs, lambda d: torch.clamp(d, d_lo, d_hi),
            lambda d: torch.argmax(self.classify_fn(d), -1) == orig)

        pn_delta, pn_ok = self._pick(pn_best, pn_dist, n)
        pp_delta, pp_ok = self._pick(pp_best, pp_dist, n)
        pn = torch.where(_rows(pn_ok, nd), x + pn_delta, x)
        pp = torch.where(_rows(pp_ok, nd), pp_delta, x)
        return pn, pn_ok, pp, pp_ok
