"""Alternating BiGAN training (port of ``imagecfgen_tpu/train/gan_trainer.py``).

Reference semantics, per step:

- one E+G update, only when ``step % d_updates_per_g_update == 0``, on the
  label-swapped loss ``0.5 * (softplus(D(x, E(x))) + softplus(-D(G(z), z)))``
  with E's and G's parameters in one Adam; D's parameters stay, but both D
  forwards of this phase move D's batch-norm buffers, in order;
- ``E(x)`` and ``G(z)`` recomputed with the new parameters, detached;
- **two** sequential discriminator Adam updates with one shared state: the
  real pair labelled 1, then the fake pair labelled 0 on the D that was just
  updated (Adam's D count rises by two per step);
- Adam(1e-4, betas 0.5 and 0.999, eps 1e-8);
- D runs in train mode throughout (dropout active, batch statistics, the
  running statistics moved by every forward);
- the diagnostics D(G(z)) and D(x, E(x)) reuse the logits of the two D
  updates; ``exact_reference_diagnostics=True`` runs D twice more instead.

The recomputation runs under ``torch.no_grad()``, which sends the encoder
through the ``fused_encoder`` kernel on the card; the E+G update
differentiates the encoder's ``PlanSequential`` (cuDNN convs).

An epoch keeps the dataset on the device, draws its permutation there from
the trainer's own generator, drops the ragged tail and accumulates the
metrics on the device: one fetch per epoch, none inside the step loop.

Opt-in modes, all off by default (the JAX package's throughput options,
``imagecfgen_tpu/train/gan_trainer.py:121-140``; ``train_mnist_image_scm
--throughput`` sets the first three):

- ``fused_d_steps``: **one** D update a step on the concatenated pairs
  ``[x; G(z)]``, ``[E(x); z]`` with loss ``bce(d_valid, 1) + bce(d_fake, 0)``
  (Adam's D count rises by one a step); D's batch norm sees the 2B batch;
- ``fused_eg_d``: the E+G phase's two D forwards as one over the same 2B
  batch;
- ``mu_dtype=torch.bfloat16``: Adam's first moment stored in bfloat16.

The JAX package's fourth mode, ``flat_adam``, is no option here: the port's
``Adam`` always keeps each moment in one buffer per network, and
``core.convert`` reads the JAX package's flat states by parameter name.

Every draw of a step (``z`` and the dropout masks of its D forwards) is
injectable, so that a test can hand this trainer and the JAX one the same
numbers.

Data parallelism (``mesh``, a ``parallel.DataMesh`` over ``W`` ranks; the
JAX trainer's ``mesh``): every rank is handed the same global batch, and
draws ``z``, the dropout masks and the epoch permutation for the global
batch from its own generator, seeded alike, so the generators stay equal
across ranks and a 1-rank and a ``W``-rank run see the same noise. Each rank
then takes its rows of each (``mesh.shard``; a 2B forward's masks are two
batches stacked) and runs the step on them: the recompute sends its local
``(B/W, ...)`` shard through ``fused_encoder``. The collectives of a step are
one gradient all-reduce for E+G and one for each D update (inside
``train.optim.Adam``), and D's batch-norm statistics (a differentiable
all-reduce of each batch norm's mean and ``E[x^2]``, forward and backward).
The step's metrics are the rank's own shard's; an epoch's totals are
averaged over the ranks once, at its end. Parameters and buffers are
broadcast from rank 0 once, at construction. Without a mesh (or with
``data_mesh(None)``) nothing is sharded and no collective is issued.

The model's ``compute_dtype`` (float32 or bfloat16) sets the type of the E,
G and D forwards, with the JAX package's semantics: the parameters and both
Adam states stay float32 (``mu`` in ``mu_dtype``), the forwards compute in
the compute type from cast copies, E's codes, G's images and D's logits come
back as float32, and ``bce_logits`` runs in float32. In bfloat16 the
recompute sends the trunk through ``fused_encoder`` in bfloat16 after every
Adam step; its weight copies (``ops.tensor_core.cast_cached``) are keyed on
each parameter's version counter, which the in-place Adam update moves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.bigan import BiGAN
from ..models.layers import sync_batch_norms
from ..parallel.mesh import DataMesh, data_mesh, module_tensors
from ._guards import require_full_batch, resolve_batch
from .optim import Adam, adam_state, assign_grads, load_adam_state

Masks = Sequence[torch.Tensor]
METRICS = ("loss_EG", "loss_D", "D_score", "EG_score")


def bce_logits(logits: torch.Tensor, target: int) -> torch.Tensor:
    """BCE-with-logits against a constant 0/1 target, mean-reduced."""
    if target == 1:
        return F.softplus(-logits).mean()
    if target == 0:
        return F.softplus(logits).mean()
    raise ValueError(target)


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    batch_size: int = 64
    d_updates_per_g_update: int = 1
    exact_reference_diagnostics: bool = False
    # rematerialise the E, G and D forwards in the backward pass
    # (torch.utils.checkpoint): more operations for fewer live activations
    remat: bool = False
    # the opt-in modes of the module docstring: Adam's first moment stored in
    # this type (None: float32); one D update on the concatenated pairs; one
    # D forward in the E+G phase
    mu_dtype: Optional[torch.dtype] = None
    fused_d_steps: bool = False
    fused_eg_d: bool = False


def _concat_pairs(x_a, x_b, z_a, z_b, attrs):
    """Two (x, z) pairs of D inputs as one 2B batch ``[a; b]``, the
    attributes repeated (the JAX package's ``_concat_pairs``)."""
    return (torch.cat([x_a, x_b]), torch.cat([z_a, z_b]),
            {k: torch.cat([v, v]) for k, v in attrs.items()})


class GANTrainer:
    """Trains a :class:`BiGAN` in place. The trainer owns the two
    optimisers, the step count and the generator of its noise; the modules
    own the parameters and D's batch-norm buffers."""

    def __init__(self, model: BiGAN, tcfg: GANTrainConfig, device: DeviceLike = None,
                 seed: int = 0, mesh: Optional[DataMesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh or data_mesh(None)
        if model.cfg.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"training computes in float32 or bfloat16, not {model.cfg.compute_dtype}")
        self.model = model.to(self.device)
        self.tcfg = tcfg
        self.params_eg = [*model.encoder.parameters(), *model.generator.parameters()]
        self.params_d = list(model.discriminator.parameters())
        adam = dict(lr=tcfg.learning_rate, betas=tuple(tcfg.betas), eps=1e-8,
                    mu_dtype=tcfg.mu_dtype or torch.float32, mesh=self.mesh)
        sync_batch_norms(model, self.mesh)
        self.mesh.replicate(module_tensors(model))
        self.opt_eg = Adam(self.params_eg, **adam)
        self.opt_d = Adam(self.params_d, **adam)
        self.step = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self._fit_batch: Optional[int] = None

    # ---------------------------------------------------------- noise

    def d_batches(self, batch: int) -> List[int]:
        """The batch of each D forward of a step, in order: the E+G phase's
        (one 2B forward with ``fused_eg_d``, else real and fake), the D
        update's (one 2B with ``fused_d_steps``, else real and fake), then
        the two exact diagnostics when they are on."""
        t = self.tcfg
        sizes = [2 * batch] if t.fused_eg_d else [batch, batch]
        sizes += [2 * batch] if t.fused_d_steps else [batch, batch]
        return sizes + ([batch, batch] if t.exact_reference_diagnostics else [])

    def draw_noise(self, batch: int) -> Tuple[torch.Tensor, List[List[torch.Tensor]]]:
        """One step's ``z`` and the dropout masks of its D forwards, at the
        batches of :meth:`d_batches`, in the order :meth:`train_step` takes
        them."""
        z = torch.randn((batch, 1, 1, self.model.cfg.latent_dim), generator=self.rng,
                        device=self.device)
        return z, [self.model.discriminator.draw_masks(n, self.rng, self.device)
                   for n in self.d_batches(batch)]

    # ---------------------------------------------------------- forwards

    def _forward_e(self, x, attrs):
        E = self.model.encoder
        if self.tcfg.remat:
            return checkpoint(lambda x: E(x, attrs, train=True), x, use_reentrant=False)
        return E(x, attrs, train=True)

    def _forward_g(self, z, attrs):
        G = self.model.generator
        if self.tcfg.remat:
            return checkpoint(lambda z: G(z, attrs, train=True), z, use_reentrant=False)
        return G(z, attrs, train=True)

    def _forward_d(self, x, z, attrs, masks: Masks):
        """D in train mode. Rematerialised, the forward runs again in the
        backward pass with the same masks and without moving the running
        statistics a second time."""
        D = self.model.discriminator
        if not self.tcfg.remat:
            return D(x, z, attrs, train=True, masks=masks)
        runs = []

        def run(x, z):
            runs.append(None)
            return D(x, z, attrs, train=True, masks=masks, update_stats=len(runs) == 1)

        return checkpoint(run, x, z, use_reentrant=False)

    # ---------------------------------------------------------- the phases

    def eg_update(self, x, attrs, z, masks: Sequence[Masks]) -> torch.Tensor:
        """One Adam update of E and G together on the label-swapped loss;
        ``masks``: those of the phase's D forwards (one with ``fused_eg_d``,
        else the real pair's and the fake pair's). Returns the loss."""
        ex = self._forward_e(x, attrs)
        gz = self._forward_g(z, attrs)
        if self.tcfg.fused_eg_d:
            b = x.shape[0]
            d = self._forward_d(*_concat_pairs(x, gz, ex, z, attrs), masks[0])
            d_valid, d_fake = d[:b], d[b:]
        else:
            d_valid = self._forward_d(x, ex, attrs, masks[0])
            d_fake = self._forward_d(gz, z, attrs, masks[1])
        loss = 0.5 * (bce_logits(d_valid, 0) + bce_logits(d_fake, 1))
        assign_grads(self.params_eg, loss)
        self.opt_eg.step()
        return loss.detach()

    @torch.no_grad()
    def recompute(self, x, attrs, z) -> Tuple[torch.Tensor, torch.Tensor]:
        """``E(x)`` and ``G(z)`` with the current parameters, carrying no
        gradient: the inputs of the two D updates. No gradient is recorded,
        so on the card the encoder runs in the ``fused_encoder`` kernel."""
        return self.model.encoder(x, attrs, train=True), self.model.generator(z, attrs, train=True)

    def d_update(self, x, z, attrs, target: int, masks: Masks) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam update of D on the pair ``(x, z)`` labelled ``target``;
        returns the loss and the logits."""
        logits = self._forward_d(x, z, attrs, masks)
        loss = bce_logits(logits, target)
        assign_grads(self.params_d, loss)
        self.opt_d.step()
        return loss.detach(), logits.detach()

    def d_update_pairs(self, x, gz, ex, z, attrs, masks: Masks):
        """``fused_d_steps``: one Adam update of D on the real and the fake
        pair as one 2B batch, on ``bce(d_valid, 1) + bce(d_fake, 0)``;
        returns the loss and both halves of the logits."""
        b = x.shape[0]
        logits = self._forward_d(*_concat_pairs(x, gz, ex, z, attrs), masks)
        loss = bce_logits(logits[:b], 1) + bce_logits(logits[b:], 0)
        assign_grads(self.params_d, loss)
        self.opt_d.step()
        logits = logits.detach()
        return loss.detach(), logits[:b], logits[b:]

    # ---------------------------------------------------------- train step

    def train_step(self, batch: Mapping, z: Optional[torch.Tensor] = None,
                   masks: Optional[Sequence[Masks]] = None) -> Dict[str, torch.Tensor]:
        """One alternating-GAN step on ``batch`` (``{"image": (B, H, W, C),
        "attrs": {...}}`` on the trainer's device). ``z`` ``(B, 1, 1,
        latent)`` and ``masks`` (one list of dropout keep masks per D forward,
        at the batches of :meth:`d_batches`) are drawn from the trainer's
        generator when None. Under a mesh all three are global and each rank
        steps on its shard. Returns the four metrics (of this rank's shard)
        as 0-d tensors on the device; nothing is fetched."""
        b = batch["image"].shape[0]
        self.mesh.check_batch(b)
        if z is None or masks is None:
            drawn_z, drawn_masks = self.draw_noise(b)
            z = drawn_z if z is None else z
            masks = drawn_masks if masks is None else masks
        shard = self.mesh.shard
        batch, z = self.mesh.shard_batch(batch), shard(z)
        masks = [[shard(m, n // b) for m in fwd] for n, fwd in zip(self.d_batches(b), masks)]
        x, attrs = batch["image"], batch["attrs"]

        n_eg = 1 if self.tcfg.fused_eg_d else 2
        eg_masks, masks = masks[:n_eg], masks[n_eg:]
        if self.step % self.tcfg.d_updates_per_g_update == 0:
            loss_eg = self.eg_update(x, attrs, z, eg_masks)
        else:
            loss_eg = torch.zeros((), device=x.device)

        ex, gz = self.recompute(x, attrs, z)
        if self.tcfg.fused_d_steps:
            loss_d, d_valid, d_fake = self.d_update_pairs(x, gz, ex, z, attrs, masks[0])
            masks = masks[1:]
        else:
            loss_d1, d_valid = self.d_update(x, ex, attrs, 1, masks[0])
            loss_d2, d_fake = self.d_update(gz, z, attrs, 0, masks[1])
            loss_d = loss_d1 + loss_d2
            masks = masks[2:]

        if self.tcfg.exact_reference_diagnostics:
            with torch.no_grad():
                D = self.model.discriminator
                d_fake = D(gz, z, attrs, train=True, masks=masks[0])
                d_valid = D(x, ex, attrs, train=True, masks=masks[1])
        self.step += 1
        return {
            "loss_EG": loss_eg,
            "loss_D": loss_d,
            "D_score": torch.sigmoid(d_fake).mean(),   # D(G(z), z)
            "EG_score": torch.sigmoid(d_valid).mean(),  # D(x, E(x))
        }

    # ---------------------------------------------------------- epochs

    def _to_device(self, tree):
        if isinstance(tree, Mapping):
            return {k: self._to_device(v) for k, v in tree.items()}
        return torch.as_tensor(tree).to(self.device)

    def run_epoch(self, batches: Mapping) -> Dict[str, float]:
        """``batches``: ``{"image", "attrs"}`` with leaves shaped
        ``(n_batches, B, ...)`` (numpy or tensors; moved to the device
        once; global batches under a mesh). Returns the epoch's mean metrics
        (averaged over the ranks), fetched once at its end."""
        batches = self._to_device(batches)
        nb = batches["image"].shape[0]
        if nb == 0:
            raise ValueError("an epoch of zero batches")
        total = torch.zeros(len(METRICS), device=self.device)
        for i in range(nb):
            m = self.train_step({"image": batches["image"][i],
                                 "attrs": {k: v[i] for k, v in batches["attrs"].items()}})
            total += torch.stack([m[k] for k in METRICS])
        return dict(zip(METRICS, (self.mesh.average_(total) / nb).tolist()))

    def upload_dataset(self, x, attrs: Mapping) -> Dict:
        """The full (image, attrs) dataset on the trainer's device. Images
        are expected already scaled to [-1, 1], NHWC."""
        return self._to_device({"image": x, "attrs": dict(attrs)})

    def fit_epoch(self, data: Mapping) -> Dict[str, float]:
        """One epoch over a device-resident dataset from
        :meth:`upload_dataset` (the whole set on every rank): a permutation
        drawn on the device, the ragged tail dropped."""
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

    def _named(self):
        m = self.model
        eg = [(f"E.{n}", p) for n, p in m.encoder.named_parameters()]
        eg += [(f"G.{n}", p) for n, p in m.generator.named_parameters()]
        return eg, list(m.discriminator.named_parameters())

    def state_dict(self) -> Dict:
        """Everything a run needs to go on bit for bit: the three modules'
        parameters and buffers, both Adam states by parameter name, the
        step, and the state of the noise generator."""
        m = self.model
        eg, d = self._named()
        return {
            "E": m.encoder.state_dict(), "G": m.generator.state_dict(),
            "D": m.discriminator.state_dict(),
            "opt_eg": adam_state(self.opt_eg, eg), "opt_d": adam_state(self.opt_d, d),
            "step": self.step, "rng": self.rng.get_state(),
        }

    def load_state_dict(self, state: Mapping) -> None:
        """Take over ``state_dict()``'s form (``rng`` may be absent: a state
        carried over from the JAX package brings no generator)."""
        m = self.model
        m.encoder.load_state_dict(state["E"])
        m.generator.load_state_dict(state["G"])
        m.discriminator.load_state_dict(state["D"])
        eg, d = self._named()
        load_adam_state(self.opt_eg, eg, state["opt_eg"])
        load_adam_state(self.opt_d, d, state["opt_d"])
        self.step = int(state["step"])
        if state.get("rng") is not None:
            self.rng.set_state(state["rng"].cpu())


def make_epoch_batches(rng: np.random.Generator, x: np.ndarray,
                       attrs: Mapping[str, np.ndarray], batch_size: int) -> Dict:
    """Host-side shuffle and batching for :meth:`GANTrainer.run_epoch`
    (drops the ragged tail)."""
    n = len(x) // batch_size * batch_size
    perm = rng.permutation(len(x))[:n]
    nb = n // batch_size

    def rs(v):
        v = np.asarray(v)[perm]
        return v.reshape((nb, batch_size) + v.shape[1:])

    return {"image": rs(x), "attrs": {k: rs(v) for k, v in attrs.items()}}
