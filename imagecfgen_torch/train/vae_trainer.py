"""Conditional-VAE training (port of ``imagecfgen_tpu/train/vae_trainer.py``;
reference ``deepscm_vae/mnist.py:136-242``).

Adam with optax's default betas, loss = -ELBO(``num_samples_per_step``,
``kl_weight``), the port's one flat ``train.optim.Adam``. Data parallelism as
in ``train.gan_trainer`` (``mesh``): the ELBO's ``eps`` is drawn for the
global batch and sliced per rank, one gradient all-reduce a step, the epoch's
mean averaged over the ranks at its end. The encoder's trunk needs a
gradient here, so it runs as its ``PlanSequential``, never through the
``fused_encoder`` kernel (see ``models/vae.py``).

The MNIST encoder and decoder plans have no dropout and no batch norm, so
train mode computes what eval mode does there; ``train=True`` is passed on
as in the JAX trainer, and a plan with dropout would draw its masks from the
trainer's generator.

As in the other trainers, an epoch keeps the data on the device, shuffles
there and fetches its mean loss once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.vae import ConditionalVAE
from ..parallel.mesh import DataMesh, data_mesh, module_tensors
from ._guards import require_full_batch, resolve_batch
from .optim import Adam, adam_state, assign_grads, load_adam_state


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 1e-4
    batch_size: int = 64
    num_samples_per_step: int = 4
    kl_weight: float = 10.0  # reference train() default (deepscm_vae/mnist.py:146)


class VAETrainer:
    """Trains ``model`` in place; owns the optimiser, the step count and the
    generator of the ELBO's noise and of the epoch permutations."""

    def __init__(self, model: ConditionalVAE, tcfg: VAETrainConfig, device: DeviceLike = None,
                 seed: int = 0, mesh: Optional[DataMesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh or data_mesh(None)
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.params = list(model.parameters())
        self.mesh.replicate(module_tensors(model))
        # optax.adam(lr)'s defaults: betas 0.9 and 0.999, eps 1e-8
        self.opt = Adam(self.params, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                        mesh=self.mesh)
        self.step = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self._fit_batch: Optional[int] = None

    def loss(self, batch: Mapping, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-ELBO of ``{"image", "attrs"}`` (attributes scaled); ``eps``
        injects the ``(B, S, 1, 1, latent)`` noise."""
        return -self.model.elbo(batch["image"], batch["attrs"], self.tcfg.num_samples_per_step,
                                self.tcfg.kl_weight, train=True, rng=self.rng, eps=eps)

    def train_step(self, batch: Mapping, eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam update; returns ``{"neg_elbo"}`` (of this rank's shard)
        as a 0-d tensor on the device. ``batch`` and ``eps`` are global
        (``eps`` drawn here for the global batch when None; the encoder draws
        nothing, so this is the draw the ELBO would make) and each rank steps
        on its shard."""
        if eps is None:
            eps = self.model.draw_eps(batch["image"].shape[0], self.tcfg.num_samples_per_step,
                                      batch["image"], self.rng)
        batch, eps = self.mesh.shard_batch(batch), self.mesh.shard(eps)
        loss = self.loss(batch, eps)
        assign_grads(self.params, loss)
        self.opt.step()
        self.step += 1
        return {"neg_elbo": loss.detach()}

    def _to_device(self, v):
        return torch.as_tensor(v).to(self.device)

    def run_epoch(self, batches: Mapping) -> Dict[str, float]:
        """``batches``: ``{"image", "attrs"}`` with leaves ``(n_batches, B,
        ...)``; returns the epoch's mean -ELBO, fetched once at its end."""
        xs = self._to_device(batches["image"])
        attrs = {k: self._to_device(v) for k, v in batches["attrs"].items()}
        if xs.shape[0] == 0:
            raise ValueError(
                "zero batches for this epoch (dataset smaller than one batch?); "
                "lower batch_size")
        total = torch.zeros((), device=self.device)
        for i in range(xs.shape[0]):
            total += self.train_step({"image": xs[i], "attrs": {k: v[i] for k, v in attrs.items()}})["neg_elbo"]
        return {"neg_elbo": (self.mesh.average_(total) / xs.shape[0]).item()}

    def upload_dataset(self, x, attrs: Mapping) -> Dict:
        """``{"image", "attrs"}`` on the trainer's device, once."""
        return {"image": self._to_device(x), "attrs": {k: self._to_device(v) for k, v in attrs.items()}}

    def fit_epoch(self, data: Mapping) -> Dict[str, float]:
        """One epoch over a device-resident dataset from
        :meth:`upload_dataset`, shuffled on the device (the ragged tail
        dropped)."""
        n = data["image"].shape[0]
        if self._fit_batch is None:
            self._fit_batch = resolve_batch(n, self.tcfg.batch_size, self.mesh.world)
        bsz = self._fit_batch
        require_full_batch(n, bsz)
        nb = n // bsz
        perm = torch.randperm(n, generator=self.rng, device=self.device)[: nb * bsz]

        def gather(v):
            return v[perm].reshape(nb, bsz, *v.shape[1:])

        return self.run_epoch({"image": gather(data["image"]),
                               "attrs": {k: gather(v) for k, v in data["attrs"].items()}})

    # ---------------------------------------------------------- state

    def state_dict(self) -> Dict:
        return {
            "module": self.model.state_dict(),
            "opt": adam_state(self.opt, self.model.named_parameters()),
            "step": self.step, "rng": self.rng.get_state(),
        }

    def load_state_dict(self, state: Mapping) -> None:
        self.model.load_state_dict(state["module"])
        load_adam_state(self.opt, self.model.named_parameters(), state["opt"])
        self.step = int(state["step"])
        if state.get("rng") is not None:
            self.rng.set_state(state["rng"].cpu())
