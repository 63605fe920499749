"""Counterfactual and generation scores
(port of ``imagecfgen_tpu/metrics/scores.py``).

- CF effectiveness: intervene on a categorical attribute with a *different*
  class, regenerate, and measure how often a classifier predicts the
  intervened class. The new class is one draw from the attribute's
  conditional with the observed class masked out: the exact law of
  resampling until the class changes.
- Generation quality: classifier accuracy on ``G(z, a)``.

Where the JAX package splits keys, the port draws from one
``torch.Generator``; every draw can also be injected, so that tests hand
both packages the same numbers. Scores come back as Python floats.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..flows.distributions import Gumbel


def resample_excluding(graph, params, state, rng: Optional[torch.Generator], node: str,
                       obs: Mapping, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw a new class for ``node`` conditionally on its parents, with the
    currently observed class excluded (Gumbel-max over the masked logits;
    ``gumbel`` injects the ``(B, n)`` Gumbels)."""
    module = graph.modules[node]
    if not module.categorical:
        raise ValueError(f"{node} is not categorical")
    current = obs[node].reshape(-1).long()
    b = current.shape[0]
    ctx = graph._context(node, obs)
    if hasattr(module, "logits") and ctx is not None:
        logits = module.logits(params[node], ctx)
    else:
        logits = params[node]["logits"].expand(b, module.n_categories)
    masked = logits.masked_fill(F.one_hot(current, module.n_categories).bool(), float("-inf"))
    if gumbel is None:
        gumbel = Gumbel().sample(rng, masked.shape, masked.device)
    return torch.argmax(masked + gumbel, dim=-1)


@torch.no_grad()
def cf_effectiveness_score(
    engine,
    classify_fn: Callable,
    x,
    attrs: Mapping,
    rng: Optional[torch.Generator],
    target_attr: str = "digit",
    mc_rounds: int = 1,
    held_out_shift: Optional[Mapping[str, float]] = None,
    noise: Optional[Sequence[Mapping]] = None,
) -> float:
    """Fraction of counterfactuals the classifier assigns to the intervened
    class. ``attrs`` in model convention (one-hot categoricals, raw units).

    ``held_out_shift`` additionally intervenes each named continuous
    attribute at (observed + shift). ``noise`` injects the draws of each
    round: a sequence of ``mc_rounds`` dicts ``{"resample": (B, n) Gumbels,
    "abduction": {node: Gumbels}}``.
    """
    total = 0.0
    obs = engine._to_graph_obs({k: engine._tensor(v) for k, v in attrs.items()})
    scm = engine.scm
    for r in range(mc_rounds):
        drawn = noise[r] if noise is not None else {}
        new_cls = resample_excluding(scm.graph, scm.params, scm.state, rng, target_attr, obs,
                                     drawn.get("resample"))
        iv = {target_attr: new_cls}
        for k, dv in (held_out_shift or {}).items():
            iv[k] = obs[k] + dv
        x_cf, _ = engine.counterfactual(x, attrs, iv, rng, drawn.get("abduction"))
        pred = torch.argmax(classify_fn(x_cf), dim=-1)
        total += float((pred == new_cls).float().mean())
    return total / mc_rounds


@torch.no_grad()
def generator_score(
    generate_fn: Callable,
    classify_fn: Callable,
    scm,
    scaler,
    rng: Optional[torch.Generator],
    n: int = 1024,
    latent_dim: int = 512,
    class_attr: str = "digit",
    attrs: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
    z: Optional[torch.Tensor] = None,
) -> float:
    """Classifier accuracy on generated samples ``G(z, a)``.

    ``attrs=None`` draws ``a`` from the attribute SCM (on ``device``);
    passing ``attrs`` (model convention, raw units) scores on those instead.
    ``z`` injects the ``(n, 1, 1, latent_dim)`` latents."""
    device = resolve_device(device)
    if attrs is None:
        samp = scm.sample(rng, n=n, device=device)
        attrs = {}
        for a in scaler.spec:
            v = samp[a.name]
            if a.is_categorical:
                attrs[a.name] = F.one_hot(v.reshape(-1).long(), a.n_categories).float()
            else:
                attrs[a.name] = v.reshape(-1)
    else:
        attrs = {k: torch.as_tensor(v, device=device) for k, v in attrs.items()}
        n = attrs[class_attr].shape[0]
    a_scaled = scaler.scale(attrs)
    if z is None:
        z = torch.randn((n, 1, 1, latent_dim), generator=rng)
    gx = generate_fn(z.to(device), a_scaled)
    pred = torch.argmax(classify_fn(gx), dim=-1)
    labels = torch.argmax(attrs[class_attr], dim=-1)
    return float((pred == labels).float().mean())
