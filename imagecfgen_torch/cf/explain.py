"""Model-agnostic counterfactual explainers (port of
``imagecfgen_tpu/cf/explain.py``).

- :class:`DeepCounterfactualExplainer`: gradient-free. Encode once, sweep
  ``sample_points`` convex mixtures of the original and the target one-hot
  through the decoder in one batched call (the decoder's soft embedding,
  ``probs @ table``, takes mixtures as they are), keep the samples the
  classifier flips, rank them by mixture weight, MSE or 1 - SSIM.
- :class:`HingeLossCFExplainer`: gradient-based. Optimise attribute logits
  (softmax for categoricals, tanh for continuous ones) and optionally a
  latent z; loss = c * margin + mean |x - x_cf|; ``steps`` steps of the
  port's ``train.optim.Adam`` in a Python loop (the JAX package's
  ``lax.fori_loop``). Its initial parameters are injectable.

Both encode under ``torch.no_grad()``: the encoder's trunk then takes the
``fused_encoder`` kernel on the card. The hinge loop takes its gradients
with ``torch.autograd.grad`` over its own parameters only, so the models'
parameters get no ``.grad``.

The L1 terms use :func:`l1_abs`, whose gradient at 0 is +1 as
``jax.grad(jnp.abs)`` gives (``torch.abs`` gives 0 there): an optimisation
that starts at ``x`` moves every pixel on its first step, as in the JAX
package.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..ops.ssim import ssim
from ..train.optim import Adam, assign_grads


def l1_abs(d: torch.Tensor) -> torch.Tensor:
    """``|d|`` with the gradient +1 at ``d == 0`` (``jnp.abs``'s), not 0."""
    return torch.where(d >= 0, d, -d)


class DeepCounterfactualExplainer:
    """``encode_fn(x, attrs) -> z``, ``decode_fn(z, attrs) -> x``,
    ``classify_fn(x) -> logits``; ``target_feature`` names the one-hot
    attribute that is swept."""

    def __init__(self, encode_fn: Callable, decode_fn: Callable, classify_fn: Callable,
                 target_feature: str):
        self.encode_fn, self.decode_fn, self.classify_fn = encode_fn, decode_fn, classify_fn
        self.target_feature = target_feature

    @torch.no_grad()
    def sweep(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor], original_class: int,
              target_class: int, sample_points: int, metric: str
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every candidate: ``(samples, metric values, flipped)``."""
        z = self.encode_fn(x, attrs)
        zr = z.repeat_interleave(sample_points, dim=0)
        cf_attrs = {k: v.repeat_interleave(sample_points, dim=0)
                    for k, v in attrs.items() if k != self.target_feature}
        eye = torch.eye(attrs[self.target_feature].shape[1], device=x.device)
        probs = torch.linspace(0.0, 1.0, sample_points, device=x.device)[:, None]
        cf_attrs[self.target_feature] = ((1 - probs) * eye[original_class][None]
                                         + probs * eye[target_class][None])

        samples = self.decode_fn(zr, cf_attrs)
        flipped = torch.argmax(self.classify_fn(samples), dim=1) == target_class
        if metric == "mixture":
            mval = probs[:, 0]
        elif metric == "mse":
            mval = ((samples - x) ** 2).reshape(sample_points, -1).mean(dim=1)
        elif metric == "ssim":
            xv = x.repeat_interleave(sample_points, dim=0)
            mval = 1.0 - ssim((xv + 1) / 2, (samples + 1) / 2, data_range=1.0, size_average=False)
        else:
            raise ValueError(metric)
        return samples, mval, flipped

    def explain(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor], target_class: int,
                sample_points: int = 100, metric: str = "mixture") -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: (1, H, W, C). Returns (samples, metric) of the flipped
        subset sorted ascending by the metric, or every candidate if none
        flips (``explain.py:86-93`` of the JAX package)."""
        with torch.no_grad():
            original_class = int(torch.argmax(self.classify_fn(x), dim=1)[0])
        samples, mval, flipped = self.sweep(x, dict(attrs), original_class, int(target_class),
                                            sample_points, metric)
        if not bool(flipped.any()):
            return samples, mval
        samples, mval = samples[flipped], mval[flipped]
        order = torch.argsort(mval, stable=True)
        return samples[order], mval[order]


class HingeLossCFExplainer:
    """Optimise the attributes (and z) that ``decode_fn`` turns into a
    counterfactual the classifier labels ``target_class``."""

    def __init__(self, encode_fn: Callable, decode_fn: Callable, classify_fn: Callable,
                 target_feature: str, latent_dim: int, categorical_features: Tuple[str, ...] = (),
                 features_to_ignore: Tuple[str, ...] = (), c: float = 10.0):
        self.encode_fn, self.decode_fn, self.classify_fn = encode_fn, decode_fn, classify_fn
        self.target_feature, self.latent_dim = target_feature, latent_dim
        self.categorical_features = tuple(categorical_features)
        self.features_to_ignore = tuple(features_to_ignore)
        self.c = c

    def _constrain(self, params: Mapping[str, torch.Tensor], attrs: Mapping[str, torch.Tensor],
                   train_z: bool):
        out = {}
        for k in attrs:
            if k in self.features_to_ignore:
                out[k] = attrs[k]
            elif k in self.categorical_features:
                out[k] = torch.softmax(params[k], dim=1)
            else:
                out[k] = torch.tanh(params[k])
        return out, (torch.tanh(params["z"]) if train_z else None)

    def init_params(self, attrs: Mapping[str, torch.Tensor], codes: torch.Tensor, train_z: bool,
                    rng: torch.Generator) -> Dict[str, torch.Tensor]:
        """0.01 * N(0, 1) of shape (1, width) per optimised attribute, in
        ``sorted(attrs)`` order, then N(0, 1) of ``codes``' shape for z when
        ``train_z`` (the JAX package's ``explain.py:121-132``), drawn on
        ``rng``'s device."""
        dev = rng.device
        params = {}
        for k in sorted(attrs):
            if k not in self.features_to_ignore:
                width = attrs[k].shape[1] if attrs[k].dim() > 1 else 1
                params[k] = 0.01 * torch.randn((1, width), generator=rng, device=dev)
        if train_z:
            params["z"] = torch.randn(tuple(codes.shape), generator=rng, device=dev)
        return params

    def loss(self, params: Mapping[str, torch.Tensor], x: torch.Tensor,
             attrs: Mapping[str, torch.Tensor], codes: torch.Tensor, original_pred: torch.Tensor,
             target_class: Optional[int], train_z: bool) -> torch.Tensor:
        """``c * h + mean |x - x_cf|``: ``h`` is the best other logit minus
        the target's (``target_class`` given), else the mean squared change
        of the logits from the original softmax (``explain.py:136-147``)."""
        attrs_cf, z = self._constrain(params, attrs, train_z)
        x_cf = self.decode_fn(z if train_z else codes, attrs_cf)
        pred = self.classify_fn(x_cf)
        if target_class is not None:
            mask = torch.arange(pred.shape[1], device=pred.device) == target_class
            max_other = pred.masked_fill(mask[None], float("-inf")).amax(dim=1)
            h = (max_other - pred[:, target_class]).mean()
        else:
            h = ((pred - original_pred) ** 2).mean()
        return self.c * h + l1_abs(x - x_cf).mean()

    def optimize(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor], codes: torch.Tensor,
                 target_class: Optional[int], train_z: bool, steps: int, lr: float,
                 init: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``steps`` Adam steps (optax's defaults: betas 0.9, 0.999, eps
        1e-8) from ``init``; returns ``(x_cf, constrained attributes)``."""
        params = {k: v.detach().to(x.device, torch.float32).clone().requires_grad_(True)
                  for k, v in init.items()}
        leaves = list(params.values())
        with torch.no_grad():
            original_pred = torch.softmax(self.classify_fn(x), dim=1)
        opt = Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            assign_grads(leaves, self.loss(params, x, attrs, codes, original_pred, target_class, train_z))
            opt.step()
        with torch.no_grad():
            attrs_cf, z = self._constrain(params, attrs, train_z)
            return self.decode_fn(z if train_z else codes, attrs_cf), attrs_cf

    def explain(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                target_class: Optional[int] = None, train_z: bool = True, steps: int = 30,
                lr: float = 0.1, rng: Optional[torch.Generator] = None,
                init: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """The counterfactual of ``x`` (1, H, W, C). The initial parameters
        are ``init`` when given, else drawn from ``rng`` (a CPU generator
        seeded 0 when None) by :meth:`init_params`."""
        attrs = dict(attrs)
        with torch.no_grad():
            codes = self.encode_fn(x, attrs)
        if init is None:
            init = self.init_params(attrs, codes, train_z,
                                    rng if rng is not None else torch.Generator().manual_seed(0))
        return self.optimize(x, attrs, codes, target_class, train_z, steps, lr, init)[0]
