"""Run one function on the ranks of a fresh process group, and record the
collectives a region issues.

:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start method: no
process inherits the caller's threads), joins them into one group through a
``file://`` rendezvous in a directory the caller names (no port is taken),
calls ``fn(mesh, *args)`` on each with its :class:`~.mesh.DataMesh`, and
returns each rank's result, tensors as numpy arrays. A rank that raises, or
a run that outlasts ``timeout``, fails the call, and no process outlives it.
Each rank computes on one host thread.

:func:`record_collectives` counts every ``torch.distributed`` collective and
point-to-point call of a region by kind, with the bytes of its tensors,
those of autograd's backward passes too.
"""
from __future__ import annotations

import contextlib
import itertools
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from typing import Callable, Dict, Iterator, List

import torch
import torch.distributed as dist

from .mesh import data_mesh

# every public entry point of torch.distributed that moves data between ranks
# (isend and irecv are reached through batch_isend_irecv, which counts them:
# P2POp accepts only the unwrapped functions)
KINDS = ("all_reduce", "broadcast", "reduce", "all_gather", "all_gather_into_tensor", "gather",
         "scatter", "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
         "send", "recv", "batch_isend_irecv", "barrier", "all_gather_object",
         "broadcast_object_list")
_RUNS = itertools.count()


def _to_host(tree):
    """Tensors of a dict / list / tuple tree as numpy arrays (bfloat16 as
    float32)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _rank_main(fn, rank: int, world: int, init: str, backend: str, args, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            value = _to_host(fn(data_mesh(dist.group.WORLD), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, workdir: str, backend: str = "gloo",
              timeout: float = 120.0) -> List:
    """``[fn(mesh, *args) on rank r for r in range(world)]``, each on a
    spawned process of one ``backend`` group. ``fn`` and ``args`` are pickled:
    ``fn`` must be importable by name from a module that imports cheaply."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(os.path.abspath(workdir), f"rendezvous-{os.getpid()}-{next(_RUNS)}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init, backend, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline, finished = [None] * world, time.monotonic() + timeout, False
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                missing = [r for r in range(world) if out[r] is None]
                raise TimeoutError(f"ranks {missing} of {world} did not finish within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        finished = True
    finally:  # after a failure the other ranks may wait in a collective: end them
        for p in procs:
            if finished:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
            p.join(5.0)
    return out


def _nbytes(arg) -> int:
    if isinstance(arg, torch.Tensor):
        return arg.numel() * arg.element_size()
    if isinstance(arg, dist.P2POp):
        return _nbytes(arg.tensor)
    if isinstance(arg, (list, tuple)):
        return sum(_nbytes(a) for a in arg)
    return 0


@contextlib.contextmanager
def record_collectives() -> Iterator[Dict[str, Dict[str, int]]]:
    """``{kind: {"count": n, "bytes": b}}`` of every collective the region
    issues through ``torch.distributed`` (``bytes``: those of the call's
    tensors, the first tensor argument's or list's)."""
    log: Dict[str, Dict[str, int]] = {}
    saved = {k: getattr(dist, k) for k in KINDS if hasattr(dist, k)}

    def recording(kind, f):
        def call(*a, **kw):
            entry = log.setdefault(kind, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += next((_nbytes(x) for x in (*a, *kw.values()) if _nbytes(x)), 0)
            return f(*a, **kw)
        return call

    for k, f in saved.items():
        setattr(dist, k, recording(k, f))
    try:
        yield log
    finally:
        for k, f in saved.items():
            setattr(dist, k, f)

