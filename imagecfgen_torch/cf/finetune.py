"""Encoder-only reconstruction fine-tuning: G frozen, E polished (port of
``imagecfgen_tpu/cf/finetune.py``; reference ``finetune_mnist_bigan.py:60-90``).

Adam (optax's defaults around ``learning_rate``) on E's parameters only;
loss = reconstruction (MSE, or 1 - SSIM of the images mapped to [0, 1])
between x and G(E(x, c), c), plus ``latent_weight`` * mean(z^2). Data
parallelism as in ``train.gan_trainer`` (``mesh``): the permutation (drawn or
given) is global, each rank steps on its rows of each batch, one gradient
all-reduce a step, the epoch's means averaged over the ranks at its end.

E is differentiated here, so its trunk takes ``Encoder.forward``'s
``needs_grad`` route (its ``PlanSequential``: cuDNN convs on the card) and
never the ``fused_encoder`` kernel, which has no backward.
``remat=True`` recomputes the E and G forwards in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the JAX package.

An epoch takes a permutation of the device-resident set (from the
fine-tuner's generator, or given), drops the ragged tail, and fetches its
mean metrics once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.bigan import BiGAN
from ..ops.ssim import ssim
from ..parallel.mesh import DataMesh, data_mesh, module_tensors
from ..train._guards import require_full_batch, resolve_batch
from ..train.optim import Adam, assign_grads


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    learning_rate: float = 1e-5
    batch_size: int = 128
    metric: str = "mse"  # "mse" | "ssim"
    latent_weight: float = 1.0
    # recompute the E and G forwards in the backward pass
    remat: bool = False


class EncoderFinetuner:
    """Trains ``bigan.encoder`` in place against ``bigan.generator``, which
    it leaves untouched; owns the optimiser, the step count and the
    generator of the epoch permutations."""

    def __init__(self, bigan: BiGAN, fcfg: FinetuneConfig, device: DeviceLike = None,
                 seed: int = 0, mesh: Optional[DataMesh] = None):
        if fcfg.metric not in ("mse", "ssim"):
            raise ValueError(f"unknown metric {fcfg.metric!r}; 'mse' or 'ssim'")
        self.device = resolve_device(device)
        self.mesh = mesh or data_mesh(None)
        self.bigan = bigan.to(self.device)
        self.fcfg = fcfg
        self.params = list(bigan.encoder.parameters())
        self.mesh.replicate(module_tensors(bigan))
        # optax.adam(lr)'s defaults: betas 0.9 and 0.999, eps 1e-8
        self.opt = Adam(self.params, lr=fcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                        mesh=self.mesh)
        self.step = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self._fit_batch: Optional[int] = None

    def rec_loss(self, x: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
        if self.fcfg.metric == "ssim":
            return 1.0 - ssim((x + 1) / 2, (xr + 1) / 2, data_range=1.0)
        return torch.mean((x - xr) ** 2)

    def losses(self, batch: Mapping):
        """(total, reconstruction, latent) of ``{"image", "attrs"}``
        (attributes scaled)."""
        x, attrs = batch["image"], batch["attrs"]
        enc, gen = self.bigan.encoder, self.bigan.generator
        if self.fcfg.remat:
            z = checkpoint(enc, x, attrs, use_reentrant=False)
            xr = checkpoint(gen, z, attrs, use_reentrant=False)
        else:
            z = enc(x, attrs)
            xr = gen(z, attrs)
        rec, latent = self.rec_loss(x, xr), torch.mean(z ** 2)
        return rec + self.fcfg.latent_weight * latent, rec, latent

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One Adam update of E on ``batch`` (the global batch under a mesh:
        each rank steps on its shard); returns ``{"rec", "latent"}`` (of this
        rank's shard) as 0-d tensors on the device."""
        self.mesh.check_batch(batch["image"].shape[0])
        loss, rec, latent = self.losses(self.mesh.shard_batch(batch))
        assign_grads(self.params, loss)
        self.opt.step()
        self.step += 1
        return {"rec": rec.detach(), "latent": latent.detach()}

    def _to_device(self, v):
        return torch.as_tensor(v).to(self.device)

    def upload_dataset(self, x, attrs: Mapping) -> Dict:
        """``{"image", "attrs"}`` on the fine-tuner's device, once."""
        return {"image": self._to_device(x), "attrs": {k: self._to_device(v) for k, v in attrs.items()}}

    def fit_epoch(self, data: Mapping, perm: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One epoch over :meth:`upload_dataset`'s set in the order of
        ``perm`` (a permutation of its rows; drawn from the fine-tuner's
        generator when None), full batches only; returns the mean metrics."""
        n = data["image"].shape[0]
        if self._fit_batch is None:
            self._fit_batch = resolve_batch(n, self.fcfg.batch_size, self.mesh.world)
        bsz = self._fit_batch
        require_full_batch(n, bsz)
        nb = n // bsz
        if perm is None:
            perm = torch.randperm(n, generator=self.rng, device=self.device)
        perm = self._to_device(perm)[: nb * bsz]
        totals = {"rec": torch.zeros((), device=self.device), "latent": torch.zeros((), device=self.device)}
        for i in range(nb):
            rows = perm[i * bsz:(i + 1) * bsz]
            out = self.train_step({"image": data["image"][rows],
                                   "attrs": {k: v[rows] for k, v in data["attrs"].items()}})
            for k in totals:
                totals[k] += out[k]
        rec, latent = (self.mesh.average_(torch.stack([totals["rec"], totals["latent"]])) / nb).tolist()
        return {"rec": rec, "latent": latent}
