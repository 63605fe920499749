"""The counterfactual engine: abduct-act-predict
(port of ``imagecfgen_tpu/cf/engine.py``).

1. counterfactual attributes via the causal graph (``graph.sample_cf`` —
   abduct flows, intervene, regenerate),
2. min/max-rescale both factual and counterfactual attributes,
3. abduct image noise z = E(x, a) — on the card, the encoder trunk is the
   hand-written CUDA kernel of ``ops/fused_encoder``,
4. predict x_cf = G(z, a_cf).

PyTorch runs the chain eagerly; there is no counterpart of the JAX
engine's ``jit``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.attributes import AttributeScaler
from ..device import DeviceLike, resolve_device
from ..models.bigan import BiGAN


class CounterfactualEngine:
    """Binds a BiGAN, an attribute SCM (any object with
    ``.graph/.params/.state/.to``; None serves :meth:`reconstruct` only)
    and a scaler, on one device."""

    def __init__(self, bigan: BiGAN, scm, scaler: AttributeScaler,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.bigan = bigan.to(self.device).eval()
        self.scm = scm.to(self.device) if scm is not None else None
        self.scaler = scaler

    # -------------------------------------------------- attr dict plumbing

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device)

    def _to_graph_obs(self, attrs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Model attr dict (one-hot categoricals) -> graph obs (int codes,
        (B,1) continuous)."""
        obs = {}
        for a in self.scaler.spec:
            v = attrs[a.name]
            obs[a.name] = torch.argmax(v, dim=-1) if a.is_categorical else v.reshape(-1, 1)
        return obs

    def _to_model_attrs(self, obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        attrs = {}
        for a in self.scaler.spec:
            v = obs[a.name]
            if a.is_categorical:
                attrs[a.name] = F.one_hot(v.reshape(-1).long(), a.n_categories).float()
            else:
                attrs[a.name] = v.reshape(-1)
        return attrs

    # -------------------------------------------------- the chain

    @torch.no_grad()
    def counterfactual(
        self,
        x,
        attrs: Mapping,
        interventions: Mapping,
        rng: Optional[torch.Generator] = None,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``x``: (B,H,W,C) in [-1,1]; ``attrs``: raw (unscaled) model attr
        dict; ``interventions``: graph-convention values (int codes for
        categoricals, (B,1) floats for continuous), applied in sorted-name
        order. ``rng`` draws any node the observation leaves out and the
        abduction's Gumbels; ``noise`` injects the latter per node (see
        ``CausalGraph.recover_noise``). Returns (x_cf, cf attr dict in model
        convention, raw units)."""
        x = self._tensor(x)
        attrs = {k: self._tensor(v) for k, v in attrs.items()}
        iv = {k: self._tensor(interventions[k]) for k in sorted(interventions)}
        cf_obs = self.scm.graph.sample_cf(
            self.scm.params, self.scm.state, rng, self._to_graph_obs(attrs), iv, noise
        )
        cf_attrs = self._to_model_attrs(cf_obs)
        z = self.bigan.encoder(x, self.scaler.scale(attrs))
        x_cf = self.bigan.generator(z, self.scaler.scale(cf_attrs))
        return x_cf, cf_attrs

    @torch.no_grad()
    def reconstruct(self, x, attrs: Mapping) -> torch.Tensor:
        """G(E(x, a), a) — the identity check of the reference eval scripts."""
        a_scaled = self.scaler.scale({k: self._tensor(v) for k, v in attrs.items()})
        z = self.bigan.encoder(self._tensor(x), a_scaled)
        return self.bigan.generator(z, a_scaled)
