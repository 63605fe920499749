"""Conditional ALI/BiGAN encoder and generator
(port of ``imagecfgen_tpu/models/bigan.py``).

- ``Encoder``:  image ++ attribute channels -> conv plan -> (B,1,1,latent)
- ``Generator``: latent ++ attribute vector -> either a 1x1-spatial deconv
  plan (``gen_input="spatial"``, MNIST) or a dense-stem plan
  (``gen_input="dense"``, AudioMNIST) -> image in [-1,1]

The one deviation from the JAX wiring: when the encoder plan is conv and
LeakyReLU only, ``Encoder`` runs its trunk through
``ops.fused_encoder.fused_encoder_forward`` — the hand-written CUDA kernel
on the card, its plain version on the CPU — where the JAX ``Encoder`` runs
``PlanSequential``. The function is the same.

This slice carries the encoders and generators of ``mnist_bigan_config``
and ``audio_mnist_bigan_config``; the discriminator (and its plans) and the
other domains' configs come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..core.attributes import MNIST_SPEC, AttributeSpec
from ..device import DeviceLike, resolve_device
from ..ops.fused_encoder import fused_encoder_forward, plan_conv_ops
from .layers import AttributeChannels, AttributeVectors, Plan, PlanSequential


@dataclasses.dataclass(frozen=True)
class BiGANConfig:
    image_size: Tuple[int, int]
    image_channels: int
    latent_dim: int
    attr_spec: AttributeSpec
    enc_plan: Plan
    gen_plan: Plan
    embed_dim: int = 256
    embed_hw: Tuple[int, int] = (16, 16)
    init_std: float = 0.01
    # float32 or bfloat16: the type of the forward's activations and cast
    # weights (parameters stay float32; outputs return as float32)
    compute_dtype: torch.dtype = torch.float32
    # "spatial": attribute vector becomes 1x1 channels next to z (MNIST style)
    # "dense":   z ++ attrs flattened into the plan's dense stem (audio style)
    gen_input: str = "spatial"


class Encoder(nn.Module):
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
        self.trunk = PlanSequential(
            cfg.enc_plan, (*cfg.image_size, in_ch), cfg.init_std, device, rng, cfg.compute_dtype
        )
        plan_conv_ops(cfg.enc_plan)  # the trunk must be conv/LeakyReLU only

    def forward(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = self.attr_channels(x, attrs)
        z = fused_encoder_forward(self.trunk.cast_parameters(), feats, self.cfg.enc_plan)
        return z.reshape(z.shape[0], *self.trunk.out_shape).float()


class Generator(nn.Module):
    def __init__(self, cfg: BiGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        spec = cfg.attr_spec
        self.attr_vectors = AttributeVectors(spec, cfg.embed_dim, device, rng, cfg.compute_dtype)
        in_feats = cfg.latent_dim + cfg.embed_dim * len(spec.categorical) + len(spec.continuous)
        if cfg.gen_input == "spatial":
            in_shape = (1, 1, in_feats)
        elif cfg.gen_input == "dense":
            in_shape = (in_feats,)
        else:
            raise ValueError(f"unknown gen_input {cfg.gen_input!r}")
        self.trunk = PlanSequential(cfg.gen_plan, in_shape, cfg.init_std, device, rng,
                                    cfg.compute_dtype)

    def forward(self, z: torch.Tensor, attrs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The attribute vector joins z as 1x1 channels ("spatial") or as
        the tail of one flat vector ("dense")."""
        b = z.shape[0]
        cd = self.cfg.compute_dtype
        vec = self.attr_vectors(attrs)
        if self.cfg.gen_input == "spatial":
            feats = torch.cat([z.reshape(b, 1, 1, -1).to(cd), vec.reshape(b, 1, 1, -1)], dim=-1)
        else:
            feats = torch.cat([z.reshape(b, -1).to(cd), vec], dim=-1)
        return self.trunk(feats).float()


class BiGAN(nn.Module):
    """Encoder and generator of one config, initialised from ``rng``."""

    def __init__(self, cfg: BiGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, rng)
        self.generator = Generator(cfg, device, rng)


def mnist_bigan_config(latent_dim: int = 512,
                       compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """28x28 Morpho-MNIST config: the same plans as the JAX package's
    ``mnist_bigan_config`` (5-conv encoder to a (1,1,latent) code, 5-deconv
    generator, LeakyReLU 0.2, init N(0, 0.01))."""
    lr = ("lrelu", 0.2)
    enc_plan = (
        ("conv", 64, 3, 2, 1), lr,
        ("conv", 128, 4, 2, 1), lr,
        ("conv", 256, 4, 2, 1), lr,
        ("conv", 512, 4, 2, 1), lr,
        ("conv", latent_dim, 1, 2, 0),
    )
    gen_plan = (
        ("convT", 512, 3, 1, 0), lr,
        ("convT", 256, 3, 2, 0), lr,
        ("convT", 128, 3, 2, 1), lr,
        ("convT", 64, 3, 2, 1), lr,
        ("convT", 1, 4, 1, 0),
        ("tanh",),
    )
    return BiGANConfig(
        image_size=(28, 28),
        image_channels=1,
        latent_dim=latent_dim,
        attr_spec=MNIST_SPEC,
        enc_plan=enc_plan,
        gen_plan=gen_plan,
        init_std=0.01,
        compute_dtype=compute_dtype,
    )


AUDIO_MNIST_SPEC = AttributeSpec.create(
    accent=15, age=5, country_of_origin=13, digit=10, gender=2, native_speaker=2
)


def audio_mnist_bigan_config(d: int = 64, latent_dim: int = 512,
                             compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """128x128 AudioMNIST spectrogram config: the same plans as the JAX
    package's ``audio_mnist_bigan_config``. Six categorical attributes, each
    embedded to a 128^2 channel; the encoder is six k5/s2/p1 convs
    128 -> 63 -> 31 -> 15 -> 7 -> 3 -> 1; the generator is a dense stem
    (512 + 6*256 -> 256d) -> (4,4,16d) -> five k5/s2/p2(+1) deconvs doubling
    4 -> 128; LeakyReLU 0.2, init N(0, 0.001)."""
    lr = ("lrelu", 0.2)
    enc_plan = (
        ("conv", d, 5, 2, 1), lr,
        ("conv", 2 * d, 5, 2, 1), lr,
        ("conv", 4 * d, 5, 2, 1), lr,
        ("conv", 8 * d, 5, 2, 1), lr,
        ("conv", 16 * d, 5, 2, 1), lr,
        ("conv", latent_dim, 5, 2, 1),
    )
    gen_plan = (
        ("dense", 256 * d),
        ("reshape", (4, 4, 16 * d)), lr,
        ("convT", 8 * d, 5, 2, 2, 1), lr,
        ("convT", 4 * d, 5, 2, 2, 1), lr,
        ("convT", 2 * d, 5, 2, 2, 1), lr,
        ("convT", d, 5, 2, 2, 1), lr,
        ("convT", 1, 5, 2, 2, 1),
        ("tanh",),
    )
    return BiGANConfig(
        image_size=(128, 128),
        image_channels=1,
        latent_dim=latent_dim,
        attr_spec=AUDIO_MNIST_SPEC,
        enc_plan=enc_plan,
        gen_plan=gen_plan,
        init_std=0.001,
        compute_dtype=compute_dtype,
        gen_input="dense",
    )
