"""The DeepSCM conditional-VAE baseline (port of
``imagecfgen_tpu/models/vae.py``).

One parametric implementation of the reference's per-domain VAEs (28^2
``deepscm_vae/mnist.py``, 128^2 ``deepscm_vae/audio_mnist.py``, 256^2
``deepscm_vae/whalecalls.py``): the encoder is the BiGAN encoder trunk plus
``cfg.vae_trunk_tail`` (a LeakyReLU; none for the whale VAE) and
1x1-conv mean and log-variance heads (``deepscm_vae/mnist.py:42-56``), the
decoder mirrors the BiGAN generator, and the likelihood is an isotropic
Gaussian centred on the decoder's output with a fixed log-variance
(``deepscm_vae/mnist.py:94-116``).

The encoder trunk follows the port's ``Encoder`` rule: when no gradient is
recorded (serving), it runs as ``ops.fused_encoder.fused_encoder_forward``
(the hand-written CUDA kernel on the card, its plain version on the CPU)
followed by the tail's LeakyReLU; when a gradient is needed (training) it
runs as its ``PlanSequential``. The two heads stay plain torch ops, as the
JAX package computes them outside any Pallas kernel.

The ELBO (``deepscm_vae/mnist.py:121-133``) averages the conditional
log-likelihood over ``num_samples`` reparameterised draws, folded into the
batch **batch-major** (eps ``(B, S, ...)`` -> ``(B*S, ...)``, the decoder
once at batch B*S), minus the analytic KL to N(0, I). Its noise comes from
an explicit ``torch.Generator`` or is injected (``eps``).

``whale_vae_config``'s tail is empty: its whole trunk, with no LeakyReLU
after it, is the kernel's when no gradient is recorded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.fused_encoder import fused_encoder_forward, plan_conv_ops
from .bigan import BiGANConfig, Generator, audio_mnist_bigan_config, mnist_bigan_config, whale_bigan_config
from .layers import AttributeChannels, PlanSequential


class VAEEncoder(nn.Module):
    """``(x, attrs)`` -> ``(mean, log_var)``, each ``(B, 1, 1, latent)``
    float32."""

    def __init__(self, cfg: BiGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        spec = cfg.attr_spec
        self.attr_channels = AttributeChannels(
            spec, cfg.image_size, cfg.embed_dim, cfg.embed_hw, device, rng, cfg.compute_dtype
        )
        in_ch = cfg.image_channels + len(spec.categorical) + len(spec.continuous)
        args = (cfg.init_std, device, rng, cfg.compute_dtype)
        self.trunk = PlanSequential(cfg.enc_plan + cfg.vae_trunk_tail, (*cfg.image_size, in_ch), *args)
        head = (("conv", cfg.latent_dim, 1, 1, 0),)
        self.mean_head = PlanSequential(head, self.trunk.out_shape, *args)
        self.log_var_head = PlanSequential(head, self.trunk.out_shape, *args)
        plan_conv_ops(cfg.enc_plan)  # the kernel's part must be conv/LeakyReLU only
        if any(op[0] != "lrelu" for op in cfg.vae_trunk_tail):
            raise ValueError(f"vae_trunk_tail must be LeakyReLUs only, got {cfg.vae_trunk_tail}")

    def needs_grad(self, feats: torch.Tensor) -> bool:
        """Whether a gradient is being recorded and the trunk's input or
        parameters ask for one."""
        return torch.is_grad_enabled() and (
            feats.requires_grad or any(p.requires_grad for p in self.trunk.parameters()))

    def features(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                 train: bool = False) -> torch.Tensor:
        """The trunk's output ``(B, 1, 1, C)`` in the compute type."""
        feats = self.attr_channels(x, attrs)
        if self.needs_grad(feats):
            return self.trunk(feats, train=train)  # differentiable: cuDNN convs on the card
        h = fused_encoder_forward(self.trunk.cast_parameters(), feats, self.cfg.enc_plan)
        h = h.reshape(h.shape[0], *self.trunk.out_shape)
        for _, slope in self.cfg.vae_trunk_tail:
            h = F.leaky_relu(h, slope)
        return h

    def forward(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.features(x, attrs, train)
        return self.mean_head(h, train=train).float(), self.log_var_head(h, train=train).float()


class VAEDecoder(Generator):
    """``(z, attrs)`` -> image: the BiGAN generator's wiring and plan."""


class ConditionalVAE(nn.Module):
    """Encoder and decoder of one config (initialised from ``rng`` in that
    order), with the reparameterised draw and the ELBO."""

    def __init__(self, cfg: BiGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None, obs_log_var: float = -5.0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.obs_log_var = obs_log_var  # fixed observation log-variance (mnist.py:96)
        self.encoder = VAEEncoder(cfg, device, rng)
        self.decoder = VAEDecoder(cfg, device, rng)

    @staticmethod
    def _noise(shape, like: torch.Tensor, rng: Optional[torch.Generator]) -> torch.Tensor:
        dev = rng.device if rng is not None else like.device
        return torch.randn(shape, generator=rng, device=dev).to(like.device)

    def draw_eps(self, batch: int, num_samples: int, like: torch.Tensor,
                 rng: Optional[torch.Generator]) -> torch.Tensor:
        """The ELBO's ``(batch, num_samples, 1, 1, latent)`` standard normals
        from ``rng``, on ``like``'s device."""
        return self._noise((batch, num_samples, *self.encoder.mean_head.out_shape), like, rng)

    def encode_sample(self, x, attrs, rng: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """A reparameterised draw from q(z|x,c). The reference scales by the
        variance rather than the standard deviation here
        (``deepscm_vae/mnist.py:61``); this is the standard
        reparameterisation, as in the JAX package."""
        mean, log_var = self.encoder(x, attrs, train=train)
        if eps is None:
            eps = self._noise(mean.shape, mean, rng)
        return mean + torch.exp(0.5 * log_var) * eps

    def elbo(self, x, attrs: Mapping[str, torch.Tensor], num_samples: int = 4,
             kl_weight: float = 1.0, train: bool = False, rng: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The batch's mean ELBO. ``eps``: the ``(B, S, 1, 1, latent)``
        standard normals, drawn from ``rng`` when None."""
        mean, log_var = self.encoder(x, attrs, train=train)
        std = torch.exp(0.5 * log_var)
        b, s = x.shape[0], num_samples
        x_flat = x.reshape(b, -1)
        obs_std = math.exp(self.obs_log_var / 2.0)

        if eps is None:
            eps = self.draw_eps(b, s, mean, rng)
        z = (mean[:, None] + std[:, None] * eps).reshape(b * s, *mean.shape[1:])
        attrs_rep = {k: torch.repeat_interleave(v, s, dim=0) for k, v in attrs.items()}
        dec = self.decoder(z, attrs_rep, train=train).reshape(b, s, -1)
        # log N(x; dec, obs_std^2 I), summed over pixels, MC-averaged over s
        d = (x_flat[:, None] - dec) / obs_std
        lp = -0.5 * (d ** 2).sum(dim=2) - x_flat.shape[1] * (
            math.log(obs_std) + 0.5 * math.log(2.0 * math.pi))
        lp = lp.mean(dim=1)

        var = std ** 2
        dkl = 0.5 * (var + mean ** 2 - 1.0 - torch.log(var)).reshape(b, -1).sum(dim=1)
        return (lp - kl_weight * dkl).mean()

    @torch.no_grad()
    def counterfactual(self, x, attrs_scaled: Mapping[str, torch.Tensor],
                       cf_attrs_scaled: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``decoder(mean of q(z|x, a), a_cf)``: the baseline's counterfactual
        (the JAX scripts' ``vae_cf``), attributes already scaled."""
        mean, _ = self.encoder(x, attrs_scaled)
        return self.decoder(mean, cf_attrs_scaled)


def mnist_vae_config(latent_dim: int = 512,
                     compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """The MNIST BiGAN's plans with the VAE's init scale
    (``deepscm_vae/training_utils.py:30-35``: N(0, 1e-4))."""
    cfg = mnist_bigan_config(latent_dim=latent_dim, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, init_std=1e-4)


def audio_mnist_vae_config(d: int = 64, latent_dim: int = 512,
                           compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """The 128^2 AudioMNIST VAE (``deepscm_vae/audio_mnist.py:176-321``): the
    audio BiGAN trunk + 1x1 mean / log-var heads, init N(0, 1e-4)."""
    cfg = audio_mnist_bigan_config(d=d, latent_dim=latent_dim, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, init_std=1e-4)



def whale_vae_config(d: int = 64, latent_dim: int = 512,
                     compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """The 256^2 whale-call VAE (``deepscm_vae/whalecalls.py:342-370``): the
    whale BiGAN trunk + 1x1 mean / log-var heads, init N(0, 1e-4), and no
    LeakyReLU after the trunk (``deepscm_vae/whalecalls.py:249-263``)."""
    cfg = whale_bigan_config(d=d, latent_dim=latent_dim, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, init_std=1e-4, vae_trunk_tail=())
