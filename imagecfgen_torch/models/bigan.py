"""Conditional ALI/BiGAN encoder, generator and discriminator
(port of ``imagecfgen_tpu/models/bigan.py``).

- ``Encoder``:  image ++ attribute channels -> conv plan -> (B,1,1,latent)
- ``Generator``: latent ++ attribute vector -> either a 1x1-spatial deconv
  plan (``gen_input="spatial"``, MNIST) or a dense-stem plan
  (``gen_input="dense"``, AudioMNIST) -> image in [-1,1]
- ``Discriminator``: joint D(x, z, c) = dxz(dx(x ++ attribute channels) ++
  dz(z)), logits ``(B, 1)``; dropout and batch norm are active when
  ``train`` (MNIST's ``dx`` has both).

The one deviation from the JAX wiring: ``Encoder`` runs its trunk through
``ops.fused_encoder.fused_encoder_forward`` — the hand-written CUDA kernel
on the card, its plain version on the CPU — where the JAX ``Encoder`` runs
``PlanSequential``. The function is the same. The kernel has no backward
(neither has the TPU kernel), so whenever a gradient is being recorded and
the encoder's input or parameters ask for one, the trunk runs as its
``PlanSequential`` instead, as the JAX ``Encoder`` always does.

This slice carries ``mnist_bigan_config`` and ``audio_mnist_bigan_config``;
the other domains' configs come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

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
    dx_plan: Plan
    dz_plan: Plan
    dxz_plan: Plan
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

    def needs_grad(self, feats: torch.Tensor) -> bool:
        """Whether a gradient is being recorded and the trunk's input or
        parameters ask for one."""
        return torch.is_grad_enabled() and (
            feats.requires_grad or any(p.requires_grad for p in self.trunk.parameters()))

    def forward(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                train: bool = False) -> torch.Tensor:
        feats = self.attr_channels(x, attrs)
        if self.needs_grad(feats):
            z = self.trunk(feats, train=train)  # differentiable: cuDNN convs on the card
        else:
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

    def forward(self, z: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                train: bool = False) -> torch.Tensor:
        """The attribute vector joins z as 1x1 channels ("spatial") or as
        the tail of one flat vector ("dense")."""
        b = z.shape[0]
        cd = self.cfg.compute_dtype
        vec = self.attr_vectors(attrs)
        if self.cfg.gen_input == "spatial":
            feats = torch.cat([z.reshape(b, 1, 1, -1).to(cd), vec.reshape(b, 1, 1, -1)], dim=-1)
        else:
            feats = torch.cat([z.reshape(b, -1).to(cd), vec], dim=-1)
        return self.trunk(feats, train=train).float()


class Discriminator(nn.Module):
    """Joint discriminator: ``dxz(cat(dx(x ++ attribute channels), dz(z)))``
    -> float32 logits ``(B, 1)``."""

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
        self.dx = PlanSequential(cfg.dx_plan, (*cfg.image_size, in_ch), *args)
        self.dz = PlanSequential(cfg.dz_plan, (1, 1, cfg.latent_dim), *args)
        if self.dx.out_shape[:2] != (1, 1) or self.dz.out_shape[:2] != (1, 1):
            raise ValueError(f"dx ends at {self.dx.out_shape} and dz at {self.dz.out_shape}, not 1x1")
        joint = self.dx.out_shape[-1] + self.dz.out_shape[-1]
        self.dxz = PlanSequential(cfg.dxz_plan, (1, 1, joint), *args)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator],
                   device: DeviceLike) -> List[torch.Tensor]:
        """The dropout keep masks of one train-mode forward, in the order
        it consumes them: those of ``dx``, then ``dz``, then ``dxz``."""
        return [m for part in (self.dx, self.dz, self.dxz)
                for m in part.draw_masks(batch, generator, device)]

    def forward(self, x: torch.Tensor, z: torch.Tensor, attrs: Mapping[str, torch.Tensor],
                train: bool = False, masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        """``masks``/``generator``/``update_stats``: as in
        ``PlanSequential.forward``, the masks as :meth:`draw_masks` orders
        them."""
        if train and masks is None:
            masks = self.draw_masks(x.shape[0], generator, x.device)
        parts, at = {}, 0
        for name in ("dx", "dz", "dxz"):
            n = len(getattr(self, name).drop_specs)
            parts[name] = masks[at:at + n] if train else None
            at += n
        if train and at != len(masks):
            raise ValueError(f"{len(masks)} dropout masks for {at} dropout ops")
        kw = {"train": train, "update_stats": update_stats}
        dx = self.dx(self.attr_channels(x, attrs), masks=parts["dx"], **kw)
        dz = self.dz(z.reshape(z.shape[0], 1, 1, -1), masks=parts["dz"], **kw)
        out = self.dxz(torch.cat([dx, dz], dim=-1), masks=parts["dxz"], **kw)
        return out.reshape(out.shape[0], 1).float()


class BiGAN(nn.Module):
    """Encoder, generator and discriminator of one config, initialised from
    ``rng`` in that order."""

    def __init__(self, cfg: BiGANConfig, device: DeviceLike = None,
                 rng: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, rng)
        self.generator = Generator(cfg, device, rng)
        self.discriminator = Discriminator(cfg, device, rng)


def mnist_bigan_config(latent_dim: int = 512,
                       compute_dtype: torch.dtype = torch.float32) -> BiGANConfig:
    """28x28 Morpho-MNIST config: the same plans as the JAX package's
    ``mnist_bigan_config`` (5-conv encoder to a (1,1,latent) code, 5-deconv
    generator, D with (dx, dz, dxz) heads, dropout and batch norm in dx
    only, LeakyReLU 0.2 in E/G and 0.1 in D, init N(0, 0.01))."""
    lr, lrd = ("lrelu", 0.2), ("lrelu", 0.1)
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
    dx_plan = (
        ("drop2d", 0.2),
        ("conv", 32, 5, 1, 0), lrd,
        ("drop2d", 0.2), ("bn",),
        ("conv", 64, 4, 2, 0), lrd,
        ("bn",), ("drop2d", 0.5),
        ("conv", 128, 4, 1, 0), lrd,
        ("bn",), ("drop2d", 0.5),
        ("conv", 256, 4, 2, 0), lrd,
        ("bn",), ("drop2d", 0.5),
        ("conv", 512, 3, 1, 0), lrd,
    )
    dz_plan = (
        ("drop2d", 0.2),
        ("conv", 512, 1, 1, 0), lrd,
        ("drop2d", 0.5),
        ("conv", 512, 1, 1, 0), lrd,
    )
    dxz_plan = (
        ("drop2d", 0.2),
        ("conv", 1024, 1, 1, 0), lrd,
        ("drop2d", 0.2),
        ("conv", 1024, 1, 1, 0), lrd,
        ("drop2d", 0.2),
        ("conv", 1, 1, 1, 0),
    )
    return BiGANConfig(
        image_size=(28, 28),
        image_channels=1,
        latent_dim=latent_dim,
        attr_spec=MNIST_SPEC,
        enc_plan=enc_plan,
        gen_plan=gen_plan,
        dx_plan=dx_plan,
        dz_plan=dz_plan,
        dxz_plan=dxz_plan,
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
    4 -> 128; D's x tower is the encoder's plan, its z and joint heads are
    1x1 convs; LeakyReLU 0.2, init N(0, 0.001), no dropout or batch norm."""
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
    dz_plan = (
        ("conv", latent_dim, 1, 1, 0), lr,
        ("conv", latent_dim, 1, 1, 0), lr,
    )
    dxz_plan = (
        ("conv", 1024, 1, 1, 0), lr,
        ("conv", 1024, 1, 1, 0), lr,
        ("conv", 1, 1, 1, 0),
    )
    return BiGANConfig(
        image_size=(128, 128),
        image_channels=1,
        latent_dim=latent_dim,
        attr_spec=AUDIO_MNIST_SPEC,
        enc_plan=enc_plan,
        gen_plan=gen_plan,
        dx_plan=enc_plan,
        dz_plan=dz_plan,
        dxz_plan=dxz_plan,
        init_std=0.001,
        compute_dtype=compute_dtype,
        gen_input="dense",
    )
