"""Classifier and oracle training (port of
``imagecfgen_tpu/train/clf_trainer.py``).

One supervised trainer over (module, loss): cross-entropy against soft
labels (``ce``, the digit and attribute classifiers), binary cross-entropy
with logits (``bce``, the per-digit oracles) and mean squared error
(``mse``). Adam(1e-4) with optax's default betas (0.9, 0.999) and eps 1e-8.

A module whose plan has a dense layer followed by LeakyReLU (the AudioMNIST
and NARW heads) trains through ``ops.fused_dense``: the hand-written kernel
forward on the card, plain matmuls backward.

As in the GAN trainer, an epoch keeps the data on the device, shuffles there
and fetches its mean loss once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ._guards import require_full_batch, resolve_batch
from .optim import adam_state, assign_grads, load_adam_state

LOSSES = ("ce", "bce", "mse")


@dataclasses.dataclass(frozen=True)
class SupervisedTrainConfig:
    learning_rate: float = 1e-4
    batch_size: int = 128
    loss: str = "ce"  # "ce" | "bce" | "mse"


class SupervisedTrainer:
    """Trains ``module`` (``forward(x, train=...)`` -> logits) in place;
    owns the optimiser, the step count and the generator of the epoch
    permutations."""

    def __init__(self, module: torch.nn.Module, tcfg: SupervisedTrainConfig,
                 device: DeviceLike = None, seed: int = 0):
        if tcfg.loss not in LOSSES:
            raise ValueError(f"unknown loss {tcfg.loss!r}; one of {LOSSES}")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.tcfg = tcfg
        self.params = list(module.parameters())
        # optax.adam(lr): betas 0.9 and 0.999, eps 1e-8, torch's defaults too
        self.opt = torch.optim.Adam(self.params, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self._fit_batch: Optional[int] = None

    def compute_loss(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.tcfg.loss == "ce":
            return -(y * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
        if self.tcfg.loss == "bce":
            return F.binary_cross_entropy_with_logits(logits, y)
        return torch.mean((logits - y) ** 2)

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One Adam update on ``{"x", "y"}`` (on the trainer's device);
        returns the loss as a 0-d tensor on the device."""
        logits = self.module(batch["x"], train=True)
        loss = self.compute_loss(logits, batch["y"])
        assign_grads(self.params, loss)
        self.opt.step()
        self.step += 1
        return {"loss": loss.detach()}

    def _to_device(self, v):
        return torch.as_tensor(v).to(self.device)

    def run_epoch(self, batches: Mapping) -> Dict[str, float]:
        """``batches``: ``{"x", "y"}`` with leaves ``(n_batches, B, ...)``;
        returns the epoch's mean loss, fetched once at its end."""
        xs, ys = self._to_device(batches["x"]), self._to_device(batches["y"])
        if xs.shape[0] == 0:
            raise ValueError("an epoch of zero batches")
        total = torch.zeros((), device=self.device)
        for i in range(xs.shape[0]):
            total += self.train_step({"x": xs[i], "y": ys[i]})["loss"]
        return {"loss": (total / xs.shape[0]).item()}

    def upload_dataset(self, x, y) -> Dict[str, torch.Tensor]:
        """(x, y) on the trainer's device, once."""
        return {"x": self._to_device(x), "y": self._to_device(y)}

    def fit_epoch(self, data: Mapping) -> Dict[str, float]:
        """One epoch over a device-resident dataset from
        :meth:`upload_dataset`, shuffled on the device."""
        n = data["x"].shape[0]
        if self._fit_batch is None:
            self._fit_batch = resolve_batch(n, self.tcfg.batch_size)
        bsz = self._fit_batch
        require_full_batch(n, bsz)
        nb = n // bsz
        perm = torch.randperm(n, generator=self.rng, device=self.device)[: nb * bsz]
        return self.run_epoch({k: v[perm].reshape(nb, bsz, *v.shape[1:]) for k, v in data.items()})

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        return self.module(self._to_device(x))

    def accuracy(self, x, labels, batch_size: int = 1024) -> float:
        """Share of ``x`` whose arg-max logit is its integer label."""
        labels = self._to_device(labels)
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        for i in range(0, len(x), batch_size):
            pred = self.predict(x[i:i + batch_size]).argmax(dim=-1)
            correct += (pred == labels[i:i + batch_size]).sum()
        return correct.item() / len(x)

    # ---------------------------------------------------------- state

    def state_dict(self) -> Dict:
        return {
            "module": self.module.state_dict(),
            "opt": adam_state(self.opt, self.module.named_parameters()),
            "step": self.step, "rng": self.rng.get_state(),
        }

    def load_state_dict(self, state: Mapping) -> None:
        self.module.load_state_dict(state["module"])
        load_adam_state(self.opt, self.module.named_parameters(), state["opt"])
        self.step = int(state["step"])
        if state.get("rng") is not None:
            self.rng.set_state(state["rng"].cpu())


def make_supervised_batches(rng: np.random.Generator, x, y, batch_size: int) -> Dict:
    """Host-side shuffle and batching for :meth:`SupervisedTrainer.run_epoch`
    (drops the ragged tail)."""
    n = len(x) // batch_size * batch_size
    perm = rng.permutation(len(x))[:n]
    nb = n // batch_size

    def rs(v):
        v = np.asarray(v)[perm]
        return v.reshape((nb, batch_size) + v.shape[1:])

    return {"x": rs(x), "y": rs(y)}
