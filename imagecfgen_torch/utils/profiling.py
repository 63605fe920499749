"""Profiling: a hard barrier for timed regions, device traces and step
timing (port of ``imagecfgen_tpu/utils/profiling.py``).

CUDA calls return before the card has finished, so a host clock read after
them measures the enqueue. Every timed region ends with :func:`sync` (or is
timed by :func:`timed`, which ends it so): ``torch.cuda.synchronize`` on the
card that holds the result, then a fetch of its first one-element tensor.
:func:`trace` records a region with ``torch.profiler`` into a Chrome trace,
and :class:`StepTimer` counts steps/s with the first ``warmup_steps`` left
out (kernel builds and the allocator's first requests must not count).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sync(tree) -> Optional[float]:
    """Hard barrier for the computation that produced ``tree``:
    ``torch.cuda.synchronize`` on every card one of its tensors lies on (the
    current card when it holds none and CUDA is in use). Returns the first
    leaf that has a dtype and one element (a tensor or a numpy array) as a
    float, else None, as the JAX package's ``sync`` does."""
    leaves = [leaf for leaf in _leaves(tree) if hasattr(leaf, "dtype")]
    cards = {t.device for t in leaves if isinstance(t, torch.Tensor) and t.is_cuda}
    for card in cards:
        torch.cuda.synchronize(card)
    if not cards and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.numel() == 1:
            return float(leaf.detach().float().item())
        if isinstance(leaf, (np.ndarray, np.generic)) and leaf.size == 1:
            return float(np.asarray(leaf).reshape(()))
    return None


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """``(fn(*args, **kwargs), seconds)``, the region closed by
    :func:`sync` on the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync(out)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed region with ``torch.profiler`` (the card's
    kernels too when CUDA is available) and write it to
    ``log_dir/trace.json``, a Chrome trace::

        with trace("chiprun_out/tr"):
            metrics = trainer.fit_epoch(data)
            sync(metrics)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Throughput accounting with warm-up exclusion: each ``with`` block (or
    :meth:`tick` interval) is one timed unit, and the first
    ``warmup_steps`` units are left out."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self._seen = 0
        self._steps = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup_steps:
            self._steps += 1
            self._elapsed += dt
        return False

    def tick(self, n_steps: int = 1) -> None:
        """Manual variant: call after each timed unit of ``n_steps``."""
        now = time.perf_counter()
        if self._t0 is not None:
            dt = now - self._t0
            self._seen += 1
            if self._seen > self.warmup_steps:
                self._steps += n_steps
                self._elapsed += dt
        self._t0 = now

    @property
    def steps_per_sec(self) -> float:
        return self._steps / self._elapsed if self._elapsed else float("nan")
