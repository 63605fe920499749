"""A dense layer with bias and LeakyReLU as one hand-written CUDA kernel, with
its plain PyTorch version and its gradient.

Port of ``imagecfgen_tpu/ops/pallas/fused_dense.py``. The CUDA source,
``csrc/fused_dense.cu``, is a kernel of its own for the heads' small-batch
shapes (the weight streamed once by TMA, the batch as the tensor-core
instruction's n) with the bias and LeakyReLU in its epilogue, in one launch;
its header states the bound on the card and what the design does about it.
The dense kernel is the port's ``(out, in)`` layout, K-major as stored.
Like the TPU kernel it takes float32 or bfloat16 tensors (all of one type),
accumulates in float32 and rounds once at the store; float32 tensors go
through 3xTF32, never through single-pass TF32.

``fused_dense_lrelu`` launches the kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors; nothing falls back. Its
``launches`` attribute counts the calls that reached the kernel. The
backward is plain matmuls, as the JAX custom VJP's is.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ._build import load_library
from .tensor_core import DTYPES, aligned16, cached, dense_rows, pack_dense, padded_depth, plan_dense


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: ``leaky_relu(x @ w.T + b, slope)`` with
    ``x (M, K)``, ``w (N, K)``, ``b (N,)``. bfloat16 tensors keep the
    kernel's semantics on any CPU: computed in float32 from the bfloat16
    values and rounded once."""
    z = x.float() @ w.float().t() + b.float()
    return torch.where(z >= 0, z, slope * z).to(x.dtype)


def _fail(msg: str):
    raise ValueError(f"fused_dense_lrelu: {msg}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of ``csrc/fused_dense.cu``, built at first use."""
    run = load_library("fused_dense").fused_dense_run
    run.restype = ctypes.c_int
    run.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return run


@functools.lru_cache(maxsize=None)
def _clusters(device: torch.device, bf16: int, nx: int):
    """How many clusters of 1..8 blocks the card runs at once, as the
    kernel counts them (``fused_dense_clusters``)."""
    count = load_library("fused_dense").fused_dense_clusters
    count.restype = ctypes.c_int
    count.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device):
        found = tuple(count(bf16, nx, s) for s in range(1, 9))
    if min(found) < 1:
        raise RuntimeError(f"fused_dense: no cluster fits the card ({found})")
    return found


def _record(w: torch.Tensor, m: int):
    """What a launch at ``m`` rows needs beside the tensors and the stream:
    the plan and the entry point's arguments that follow from it. Made once
    per weight, row count and type, and made again when ``cached`` sees the
    weight change. It holds no tensor: a record that held ``w`` would keep
    the weight alive in the cache for the life of the process."""
    n, k = w.shape
    bf16 = int(w.dtype == torch.bfloat16)
    plan = plan_dense(m, n, k, w.dtype, _clusters(w.device, bf16, dense_rows(m)))
    return plan, (bf16, m, n, k, padded_depth(k, w.dtype))


def launch_plan(w: torch.Tensor, m: int):
    """The plan ``fused_dense_lrelu`` launches ``w`` with at ``m`` rows (a
    CUDA weight: the card's cluster counts are read)."""
    return cached(w, f"dense_launch:{m}", lambda t: _record(t, m))[0]


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, slope: float) -> torch.Tensor:
    if x.device.type != "cuda":
        _fail(f"no kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        _fail("tensors must be contiguous")
    (m, k), n = x.shape, w.shape[0]
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if m == 0 or n == 0:
        return y
    if k == 0:
        _fail("empty reduction")
    plan, args = cached(w, f"dense_launch:{m}", lambda t: _record(t, m))
    # a ragged or unaligned weight is read from a padded copy, one for all row counts
    a = w if args[-1] == k and aligned16(w) else cached(w, "dense_padded", pack_dense)
    run = _kernel_entry()
    # the raw handle of the current stream: building the Stream object that
    # torch.cuda.current_stream() returns costs about 10 us on the card's host
    index = x.device.index
    with torch.cuda.device(index) if index != torch.cuda.current_device() else contextlib.nullcontext():
        rc = run(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), *args, slope, plan.nx, plan.split,
                 torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"fused_dense kernel failed with CUDA error {rc}")
    fused_dense_lrelu.launches += 1
    return y


class FusedDenseLReLU(torch.autograd.Function):
    """``leaky_relu(x @ w.T + b)``: the kernel (CUDA) or the plain version
    (CPU) forward; the JAX ``_bwd`` as plain matmuls backward."""

    @staticmethod
    def forward(ctx, x, w, b, slope):
        out = fused_dense_reference(x, w, b, slope) if x.device.type == "cpu" else _launch(x, w, b, slope)
        ctx.save_for_backward(x, w, out)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        # d/dz leaky_relu(z) = 1 if z >= 0 else slope; out >= 0 <=> z >= 0
        # (the JAX ``_bwd``: float32 accumulation, results in the operands' types)
        gz = torch.where(out >= 0, g, ctx.slope * g).float()
        return ((gz @ w.float()).to(x.dtype), (gz.t() @ x.float()).to(w.dtype),
                gz.sum(0).to(g.dtype), None)


def fused_dense_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      slope: float = 0.2) -> torch.Tensor:
    """``leaky_relu(x @ w.T + b, slope)``: ``x (M, K)``, ``w (N, K)`` (the
    port's dense layout), ``b (N,)`` -> ``(M, N)``."""
    if not (x.dim() == 2 and w.dim() == 2 and b.dim() == 1):
        _fail(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not (w.shape[1] == x.shape[1] and b.shape[0] == w.shape[0]):
        _fail(f"x {tuple(x.shape)} @ w {tuple(w.shape)}.T + b {tuple(b.shape)} do not match")
    if not (w.device == x.device and b.device == x.device):
        _fail(f"tensors on {x.device}, {w.device}, {b.device}")
    if x.dtype not in DTYPES:
        _fail(f"takes float32 or bfloat16, got {x.dtype}")
    if not (w.dtype == x.dtype and b.dtype == x.dtype):
        _fail(f"mixed types {x.dtype}, {w.dtype}, {b.dtype}")
    return FusedDenseLReLU.apply(x, w, b, float(slope))


fused_dense_lrelu.launches = 0
