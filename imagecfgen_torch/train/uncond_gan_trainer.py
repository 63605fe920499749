"""Unconditional GAN / WGAN-GP training (port of
``imagecfgen_tpu/train/uncond_gan_trainer.py``; reference
``gans/audio_mnist.py:227-330``).

Per step, with the JAX trainer's semantics:

- a G update only when ``step % d_updates_per_g_update == 0``, decided
  before the step (``lax.cond`` on the step count), on ``bce(D(G(z)), 1)``
  (``loss_mode="gan"``) or ``-mean(D(G(z)))`` (``"wgan"``);
- one D update on ``G(z')`` with the gradient stopped, drawn with the G of
  this step (updated or not): ``0.5 * (bce(D(x), 1) + bce(D(G(z')), 0))``,
  or ``models.gan.wgan_disc_loss`` with its gradient penalty;
- Adam(lr, betas (0.5, 0.9)) on G; on D the same, or optax's ``adamw``
  (decoupled decay on every parameter) when ``discriminator_weight_decay``
  is set: both the port's one flat ``train.optim.Adam``.

Every draw of a step (``z``, ``z'`` and the penalty's interpolation weights)
is injectable, so that a test can hand this trainer and the JAX one the same
numbers; otherwise they come from the trainer's own generator, in that
order (``z`` only on steps that update G). Data parallelism as in
``train.gan_trainer`` (``mesh``): the three draws are made for the global
batch and sliced per rank, one gradient all-reduce for each of the G and D
updates; D has no batch norm, so the penalty's double backward meets no
collective. An epoch keeps the data on the
device, draws its permutation there, drops the ragged tail and fetches its
mean metrics once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.gan import UncondDiscriminator, UncondGANConfig, UncondGenerator, wgan_disc_loss
from ..parallel.mesh import DataMesh, data_mesh, module_tensors
from ._guards import require_full_batch, resolve_batch
from .gan_trainer import bce_logits
from .optim import Adam, adam_state, assign_grads, load_adam_state

METRICS = ("loss_G", "loss_D")


@dataclasses.dataclass(frozen=True)
class UncondGANTrainConfig:
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.9)
    batch_size: int = 64
    d_updates_per_g_update: int = 1
    loss_mode: str = "gan"  # "gan" | "wgan"
    penalty_weight: float = 10.0
    discriminator_weight_decay: float = 0.0


class UncondGANTrainer:
    """Owns G, D, their two optimisers, the step count and the generator of
    the noise."""

    def __init__(self, cfg: UncondGANConfig, tcfg: UncondGANTrainConfig, device: DeviceLike = None,
                 seed: int = 0, mesh: Optional[DataMesh] = None):
        if tcfg.loss_mode not in ("gan", "wgan"):
            raise ValueError(f"unknown loss_mode {tcfg.loss_mode!r}; 'gan' or 'wgan'")
        self.device = resolve_device(device)
        self.mesh = mesh or data_mesh(None)
        self.cfg, self.tcfg = cfg, tcfg
        init = torch.Generator().manual_seed(seed)
        self.G = UncondGenerator(cfg, self.device, init)
        self.D = UncondDiscriminator(cfg, self.device, init)
        self.mesh.replicate(module_tensors(self.G, self.D))
        adam = dict(lr=tcfg.learning_rate, betas=tuple(tcfg.betas), eps=1e-8, mesh=self.mesh)
        self.params_g, self.params_d = list(self.G.parameters()), list(self.D.parameters())
        self.opt_g = Adam(self.params_g, **adam)
        self.opt_d = Adam(self.params_d, **adam, weight_decay=tcfg.discriminator_weight_decay)
        self.step = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._fit_batch: Optional[int] = None

    def _normal(self, b: int) -> torch.Tensor:
        return torch.randn((b, self.cfg.latent_dim), generator=self.rng, device=self.device)

    def _d(self, img: torch.Tensor) -> torch.Tensor:
        return self.D(img, train=True)

    def train_step(self, batch: Mapping, z_g: Optional[torch.Tensor] = None, z_d: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step on ``{"image": (B, H, W, 1)}``; ``z_g`` (the G update's
        latents), ``z_d`` (the D update's) and ``eps`` (the penalty's
        ``(B, 1, 1, 1)`` weights) are drawn when None. Under a mesh all four
        are global and each rank steps on its shard. Returns the metrics (of
        this rank's shard) as 0-d tensors on the device."""
        b = batch["image"].shape[0]
        self.mesh.check_batch(b)
        shard = self.mesh.shard
        x = shard(batch["image"])
        wgan = self.tcfg.loss_mode == "wgan"
        if self.step % self.tcfg.d_updates_per_g_update == 0:
            z_g = shard(self._normal(b) if z_g is None else z_g)
            d = self._d(self.G(z_g, train=True))
            loss_g = bce_logits(d, 1) if not wgan else -d.mean()
            assign_grads(self.params_g, loss_g)
            self.opt_g.step()
            loss_g = loss_g.detach()
        else:
            loss_g = torch.zeros((), device=x.device)

        z_d = shard(self._normal(b) if z_d is None else z_d)
        with torch.no_grad():
            fake = self.G(z_d, train=True)
        if wgan:
            if eps is None:
                eps = torch.rand((b, 1, 1, 1), generator=self.rng, device=self.device)
            eps = shard(eps)
            loss_d = wgan_disc_loss(self._d, x, fake, eps, self.tcfg.penalty_weight)
        else:
            loss_d = 0.5 * (bce_logits(self._d(x), 1) + bce_logits(self._d(fake), 0))
        assign_grads(self.params_d, loss_d)
        self.opt_d.step()
        self.step += 1
        return {"loss_G": loss_g, "loss_D": loss_d.detach()}

    def upload_dataset(self, x) -> Dict:
        """``{"image"}`` on the trainer's device, once (images in [-1, 1])."""
        return {"image": torch.as_tensor(x).to(self.device)}

    def fit_epoch(self, data: Mapping) -> Dict[str, float]:
        """One epoch over :meth:`upload_dataset`'s set, permuted on the
        device from the trainer's generator, full batches only; returns the
        mean metrics, fetched once at its end."""
        n = data["image"].shape[0]
        if self._fit_batch is None:
            self._fit_batch = resolve_batch(n, self.tcfg.batch_size, self.mesh.world)
        bsz = self._fit_batch
        require_full_batch(n, bsz)
        nb = n // bsz
        perm = torch.randperm(n, generator=self.rng, device=self.device)[: nb * bsz]
        batches = data["image"][perm].reshape(nb, bsz, *data["image"].shape[1:])
        total = torch.zeros(len(METRICS), device=self.device)
        for i in range(nb):
            m = self.train_step({"image": batches[i]})
            total += torch.stack([m[k] for k in METRICS])
        return dict(zip(METRICS, (self.mesh.average_(total) / nb).tolist()))

    # ---------------------------------------------------------- state

    def state_dict(self) -> Dict:
        """Everything a run needs to go on bit for bit: both modules, both
        Adam states by parameter name, the step and the generator's state."""
        return {"G": self.G.state_dict(), "D": self.D.state_dict(),
                "opt_g": adam_state(self.opt_g, self.G.named_parameters()),
                "opt_d": adam_state(self.opt_d, self.D.named_parameters()),
                "step": self.step, "rng": self.rng.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        """Take over ``state_dict()``'s form (``rng`` may be None: a state
        carried over from the JAX package brings no generator)."""
        self.G.load_state_dict(state["G"])
        self.D.load_state_dict(state["D"])
        load_adam_state(self.opt_g, self.G.named_parameters(), state["opt_g"])
        load_adam_state(self.opt_d, self.D.named_parameters(), state["opt_d"])
        self.step = int(state["step"])
        if state.get("rng") is not None:
            self.rng.set_state(state["rng"].cpu())
