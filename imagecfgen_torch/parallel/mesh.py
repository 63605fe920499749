"""Data parallelism over a ``torch.distributed`` process group (port of
``imagecfgen_tpu/parallel/mesh.py``).

The JAX package trains on a 1-D ``("data",)`` mesh: the batch sharded along
its leading axis, the parameters replicated, and GSPMD inserting the
gradient all-reduce and the cross-device reductions of every batch
statistic. Here one process drives one shard, and :class:`DataMesh` is the
handle the trainers take:

- ``shard``: rank ``r`` of ``W`` takes rows ``[r B/W, (r+1) B/W)`` of a
  global batch of ``B`` rows (``P("data")``); every rank holds the same
  number of rows, so a mean over ranks of per-rank means is the mean over the
  global batch;
- ``replicate``: parameters and buffers broadcast from rank 0 once, one
  collective per dtype;
- ``average_``: one optimiser's gradients, flattened into one buffer,
  ``all_reduce(SUM)`` and divided by ``W``: one collective per optimiser
  update, before the port's own ``train.optim.Adam`` step;
- ``mean_across``: a differentiable all-reduce for batch statistics, whose
  backward sums the upstream gradients across ranks, as the chain rule asks
  when each rank differentiates its own share of the loss (the contract of
  ``torch.distributed.nn.functional.all_reduce``, which newer torch marks
  deprecated).

``data_mesh(None)`` is one process with no collective: every call above is
the identity, and a trainer computes exactly what it computed before it took
a mesh. ``torch.nn.parallel.DistributedDataParallel`` is not used: it
broadcasts buffers on every forward, assumes one backward per forward (a GAN
step has several D forwards and two optimisers), and a wrapper around the
encoder would send it down the route that needs a gradient.

:func:`init_from_env` joins the group ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``): NCCL for a card, one card per process,
gloo for the CPU. A process group that is already initialised is taken as
it is.
"""
from __future__ import annotations

import atexit
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


class DataMesh:
    """A 1-D data-parallel handle: ``rank`` of ``world`` in ``group``
    (``group=None``: one process, no collective)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints and writes files."""
        return self.rank == 0

    def check_batch(self, batch: int) -> None:
        """A global batch must split into equal shards."""
        if batch % self.world:
            raise ValueError(f"a global batch of {batch} rows does not split over {self.world} ranks")

    def shard(self, t: torch.Tensor, blocks: int = 1) -> torch.Tensor:
        """This rank's rows of ``t``'s leading axis. ``blocks > 1``: ``t`` is
        ``blocks`` global batches stacked (``[a; b]``), and the shard is this
        rank's rows of each, stacked the same way."""
        if self.group is None:
            return t
        if blocks > 1:
            return torch.cat([self.shard(part) for part in t.chunk(blocks)])
        self.check_batch(t.shape[0])
        n = t.shape[0] // self.world
        return t[self.rank * n:(self.rank + 1) * n]

    def shard_batch(self, tree):
        """:meth:`shard` on every tensor of a (nested) dict: a batch."""
        if isinstance(tree, dict):
            return {k: self.shard_batch(v) for k, v in tree.items()}
        return self.shard(tree)

    @torch.no_grad()
    def replicate(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` in place with rank 0's values: one broadcast
        of one flat buffer per dtype."""
        if self.group is None:
            return
        src = dist.get_global_rank(self.group, 0)
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src, group=self.group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))

    @torch.no_grad()
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, dist.ReduceOp.SUM, group=self.group)
        return t

    @torch.no_grad()
    def average_(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` averaged over the ranks, in place: the gradient
        all-reduce."""
        if self.group is not None:
            self.sum_(flat).div_(self.world)
        return flat

    def mean_across(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``t``, differentiable (its backward sums
        the upstream gradients over the ranks, then divides by ``W``)."""
        if self.group is None:
            return t
        return _SumAcross.apply(t, self) / self.world


class _SumAcross(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is ``all_reduce(SUM)`` of the
    upstream gradient (itself differentiable, for a double backward)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.sum_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _SumAcross.apply(grad, ctx.mesh), None


def data_mesh(group: Optional[dist.ProcessGroup] = None) -> DataMesh:
    """The data-parallel handle over ``group``; None: one process, no
    collective."""
    return DataMesh(group)


def module_tensors(*modules: torch.nn.Module) -> List[torch.Tensor]:
    """Every parameter and buffer of ``modules``: what :meth:`replicate`
    broadcasts at a trainer's construction."""
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def init_from_env(device: DeviceLike = None) -> Tuple[DataMesh, torch.device]:
    """``(mesh, device)`` for this process. Under ``torchrun`` (``WORLD_SIZE``
    set) it joins the group the launcher describes: NCCL on
    ``cuda:LOCAL_RANK`` when ``device`` is a card, gloo when it is the CPU;
    it raises when more ranks on this host ask for NCCL than there are
    cards. A group this process already initialised is taken as it is, on
    ``device``. Otherwise: one process, no collective, ``device`` unchanged."""
    device = resolve_device(device)
    if dist.is_initialized():
        return data_mesh(dist.group.WORLD), device
    if "WORLD_SIZE" not in os.environ:
        return data_mesh(None), device
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
        cards = torch.cuda.device_count()
        if max(per_host, local + 1) > cards:
            raise RuntimeError(
                f"{per_host} ranks on this host ask for NCCL, one card each, and it has {cards}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    atexit.register(_leave_group)
    return data_mesh(dist.group.WORLD), device


def _leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
