"""Evaluation classifiers and oracles
(port of ``imagecfgen_tpu/models/classifier.py``).

One CNN classifier over plan data covers the MNIST digit classifier, the
binary per-digit oracles, the AudioMNIST attribute classifier and the NARW
call-type classifier. The AudioMNIST and NARW heads are ``dense`` followed
by ``lrelu``, so ``PlanSequential`` runs them through
``ops.fused_dense.fused_dense_lrelu``. The per-class conv autoencoder of the
CF realism metric is two plans, ``encoder`` and ``decoder``; neither has a
dense layer followed directly by LeakyReLU (the decoder's stem is dense ->
reshape -> lrelu), so it reaches no kernel of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
from .layers import Plan, PlanSequential


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    plan: Plan
    image_size: Tuple[int, int]
    image_channels: int = 1
    n_classes: int = 10
    init_std: Any = None  # None: lecun-normal (fan-in) init
    compute_dtype: torch.dtype = torch.float32  # parameters stay float32


class CNNClassifier(nn.Module):
    """NHWC images in [-1, 1] -> f32 logits ``(B, n_classes)``."""

    def __init__(self, cfg: ClassifierConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.trunk = PlanSequential(
            cfg.plan, (*cfg.image_size, cfg.image_channels), cfg.init_std, device, rng,
            cfg.compute_dtype,
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``train``: as in ``PlanSequential.forward`` (no config here has
        dropout or batch norm, so both modes agree)."""
        return self.trunk(x, train=train).float()


def mnist_classifier_config() -> ClassifierConfig:
    """4-conv digit classifier, 28 -> 26 -> 12 -> 10 -> 4 -> dense(10)."""
    lr = ("lrelu", 0.2)
    plan = (
        ("conv", 32, 3, 1, 0), lr,
        ("conv", 64, 3, 2, 0), lr,
        ("conv", 128, 3, 1, 0), lr,
        ("conv", 256, 3, 2, 0), lr,
        ("flatten",),
        ("dense", 10),
    )
    return ClassifierConfig(plan=plan, image_size=(28, 28), n_classes=10)


def mnist_oracle_config() -> ClassifierConfig:
    """Binary per-digit oracle: the same trunk, one output logit."""
    lr = ("lrelu", 0.2)
    plan = (
        ("conv", 32, 3, 1, 0), lr,
        ("conv", 64, 3, 2, 0), lr,
        ("conv", 128, 3, 1, 0), lr,
        ("conv", 256, 3, 2, 0), lr,
        ("flatten",),
        ("dense", 1),
    )
    return ClassifierConfig(plan=plan, image_size=(28, 28), n_classes=1)


def audio_mnist_classifier_config(num_classes: int = 10, width: float = 1.0) -> ClassifierConfig:
    """7-conv AudioMNIST attribute classifier over 128^2 spectrograms:
    128 -> 126 -> 62 -> 60 -> 29 -> 14 -> 6 -> 2, flatten 4096 -> dense 1024
    + LeakyReLU -> dense ``num_classes``. ``width`` scales every channel
    count (1.0 = reference widths, never below 8)."""
    lr = ("lrelu", 0.2)
    w = lambda c: max(int(c * width), 8)  # noqa: E731
    plan = (
        ("conv", w(32), 3, 1, 0), lr,
        ("conv", w(64), 3, 2, 0), lr,
        ("conv", w(128), 3, 1, 0), lr,
        ("conv", w(256), 3, 2, 0), lr,
        ("conv", w(512), 3, 2, 0), lr,
        ("conv", w(1024), 3, 2, 0), lr,
        ("conv", w(1024), 3, 2, 0), lr,
        ("flatten",),
        ("dense", w(1024)), lr,
        ("dense", num_classes),
    )
    return ClassifierConfig(plan=plan, image_size=(128, 128), n_classes=num_classes)


def narw_classifier_config(num_classes: int = 3, width: float = 1.0) -> ClassifierConfig:
    """8-conv NARW call-type classifier over 256^2 spectrograms; ``width``
    scales channel counts (1.0 = reference widths, never below 8)."""
    lr = ("lrelu", 0.2)
    w = lambda c: max(int(c * width), 8)  # noqa: E731
    plan = (
        ("conv", w(32), 3, 1, 0), lr,
        ("conv", w(64), 3, 2, 0), lr,
        ("conv", w(128), 3, 1, 0), lr,
        ("conv", w(256), 3, 2, 0), lr,
        ("conv", w(512), 3, 2, 0), lr,
        ("conv", w(1024), 3, 2, 0), lr,
        ("conv", w(1024), 3, 2, 0), lr,
        ("conv", w(1024), 3, 2, 0), lr,
        ("flatten",),
        ("dense", w(1024)), lr,
        ("dense", num_classes),
    )
    return ClassifierConfig(plan=plan, image_size=(256, 256), n_classes=num_classes)


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    latent_dim: int = 100
    image_size: Tuple[int, int] = (28, 28)
    compute_dtype: torch.dtype = torch.float32  # parameters stay float32


class ConvAutoEncoder(nn.Module):
    """Per-class conv autoencoder for the CF realism metric (latent 100 by
    default): NHWC images in [-1, 1] -> f32 reconstructions of the same
    shape."""

    def __init__(self, cfg: AutoEncoderConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        lr = ("lrelu", 0.2)
        enc_plan = (
            ("conv", 32, 3, 2, 1), lr,     # 28 -> 14
            ("conv", 64, 3, 2, 1), lr,     # 14 -> 7
            ("conv", 128, 3, 2, 1), lr,    # 7 -> 4
            ("flatten",),
            ("dense", cfg.latent_dim),
        )
        dec_plan = (
            ("dense", 4 * 4 * 128),
            ("reshape", (4, 4, 128)), lr,
            ("convT", 64, 3, 2, 1), lr,    # 4 -> 7
            ("convT", 32, 4, 2, 1), lr,    # 7 -> 14
            ("convT", 1, 4, 2, 1),         # 14 -> 28
            ("tanh",),
        )
        self.encoder = PlanSequential(enc_plan, (*cfg.image_size, 1), None, device, rng,
                                      cfg.compute_dtype)
        self.decoder = PlanSequential(dec_plan, (cfg.latent_dim,), None, device, rng,
                                      cfg.compute_dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(self.encoder(x, train=train), train=train).float()
