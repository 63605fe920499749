"""The unconditional spectrogram GAN / WGAN-GP (port of
``imagecfgen_tpu/models/gan.py``; the reference's ``gans/audio_mnist.py``:
latent 100, a dense-stem generator to 128^2, a five-conv discriminator, and
the Wasserstein loss with a gradient penalty).

The gradient penalty differentiates D's output with respect to its input and
then that gradient's norm with respect to D's parameters: a gradient of a
gradient (``torch.autograd.grad(..., create_graph=True)``). D's plan ends
``flatten -> dense 1`` and G's stem is ``dense -> reshape -> lrelu``, so
neither has the dense -> lrelu pair that ``PlanSequential`` runs as the
``fused_dense`` kernel (whose backward is not differentiable again): every
op of both is a plain torch op (cuDNN convs on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
from .layers import Plan, PlanSequential


@dataclasses.dataclass(frozen=True)
class UncondGANConfig:
    latent_dim: int = 100
    image_size: Tuple[int, int] = (128, 128)
    d: int = 64
    init_std: float = 0.001
    compute_dtype: torch.dtype = torch.float32

    @property
    def gen_plan(self) -> Plan:
        lr = ("lrelu", 0.2)
        d = self.d
        return (
            ("dense", 256 * d),
            ("reshape", (4, 4, 16 * d)), lr,
            ("convT", 8 * d, 5, 2, 2, 1), lr,
            ("convT", 4 * d, 5, 2, 2, 1), lr,
            ("convT", 2 * d, 5, 2, 2, 1), lr,
            ("convT", d, 5, 2, 2, 1), lr,
            ("convT", 1, 5, 2, 2, 1),
            ("tanh",),
        )

    @property
    def disc_plan(self) -> Plan:
        lr = ("lrelu", 0.2)
        d = self.d
        return (
            ("conv", d, 5, 2, 0), lr,
            ("conv", 2 * d, 5, 2, 0), lr,
            ("conv", 4 * d, 5, 2, 0), lr,
            ("conv", 8 * d, 5, 2, 0), lr,
            ("conv", 16 * d, 5, 2, 0), lr,
            ("flatten",),
            ("dense", 1),
        )


class UncondGenerator(nn.Module):
    """``z`` ``(B, latent)`` (or any shape with B rows) -> ``(B, H, W, 1)``
    float32 in [-1, 1]."""

    def __init__(self, cfg: UncondGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.trunk = PlanSequential(cfg.gen_plan, (cfg.latent_dim,), cfg.init_std, resolve_device(device), rng,
                                    cfg.compute_dtype)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.trunk(z.reshape(z.shape[0], -1), train=train).float()


class UncondDiscriminator(nn.Module):
    """``(B, H, W, 1)`` -> logits ``(B, 1)`` float32."""

    def __init__(self, cfg: UncondGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.trunk = PlanSequential(cfg.disc_plan, (*cfg.image_size, 1), cfg.init_std, resolve_device(device),
                                    rng, cfg.compute_dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.trunk(x, train=train).float()


def gradient_penalty(disc: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty on the interpolates ``eps * real + (1 - eps) * fake``
    (``eps`` ``(B, 1, 1, 1)`` from U(0, 1); reference
    ``image_scms/training_utils.py:131-147``): the mean of
    ``(||d disc(x) / d x|| - 1)^2``, differentiable in D's parameters."""
    interp = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2, 3)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def wgan_disc_loss(disc: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor, fake: torch.Tensor,
                   eps: torch.Tensor, penalty_weight: float = 10.0) -> torch.Tensor:
    """``E[D(fake)] - E[D(real)] + penalty_weight * GP`` (reference
    ``training_utils.py:150-162``)."""
    loss = disc(fake).mean() - disc(real).mean()
    return loss + penalty_weight * gradient_penalty(disc, real, fake, eps)
