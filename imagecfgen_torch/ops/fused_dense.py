"""A dense layer with bias and LeakyReLU as one hand-written CUDA kernel, with
its plain PyTorch version and its gradient.

Port of ``imagecfgen_tpu/ops/pallas/fused_dense.py``. The CUDA source,
``csrc/fused_dense.cu``, runs the encoder's tensor-core main loop
(``csrc/tc_gemm.cuh``) with the bias and LeakyReLU in its epilogue, in one
launch; its header states the bound on the card and what the design does
about it. The dense kernel is the port's ``(out, in)`` layout, K-major as
stored. Like the TPU kernel it takes float32 or bfloat16 tensors (all of
one type), accumulates in float32 and rounds once at the store; float32
tensors go through 3xTF32, never through single-pass TF32.

``fused_dense_lrelu`` launches the kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors; nothing falls back. Its
``launches`` attribute counts the calls that reached the kernel. The
backward is plain matmuls, as the JAX custom VJP's is.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .tensor_core import DTYPES, aligned16, cached, pack_rows, padded_depth, plan_gemm, sm_count


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: ``leaky_relu(x @ w.T + b, slope)`` with
    ``x (M, K)``, ``w (N, K)``, ``b (N,)``. bfloat16 tensors keep the
    kernel's semantics on any CPU: computed in float32 from the bfloat16
    values and rounded once."""
    z = x.float() @ w.float().t() + b.float()
    return torch.where(z >= 0, z, slope * z).to(x.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_dense_lrelu: {msg}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of ``csrc/fused_dense.cu``, built at first use."""
    run = load_library("fused_dense").fused_dense_run
    run.restype = ctypes.c_int
    run.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return run


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, slope: float) -> torch.Tensor:
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    for t in (x, w, b):
        _check(t.is_contiguous(), "tensors must be contiguous")
    (m, k), n = x.shape, w.shape[0]
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if m == 0 or n == 0:
        return y
    _check(k > 0, "empty reduction")
    plan = plan_gemm(m, n, k, k, x.dtype, sm_count(x.device))
    _check(not plan.vec or aligned16(x), "x must be 16-byte aligned")
    packed = cached(w, "packed_rows", pack_rows)
    run = _kernel_entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = run(x.data_ptr(), packed[0].data_ptr(),
                 packed[1].data_ptr() if len(packed) > 1 else None, b.data_ptr(), y.data_ptr(),
                 int(x.dtype == torch.bfloat16), m, n, k, padded_depth(k, x.dtype), float(slope),
                 plan.tile, plan.split, int(plan.vec), stream)
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
    _check(x.dim() == 2 and w.dim() == 2 and b.dim() == 1,
           f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    _check(w.shape[1] == x.shape[1] and b.shape[0] == w.shape[0],
           f"x {tuple(x.shape)} @ w {tuple(w.shape)}.T + b {tuple(b.shape)} do not match")
    _check(w.device == x.device and b.device == x.device,
           f"tensors on {x.device}, {w.device}, {b.device}")
    _check(x.dtype in DTYPES, f"takes float32 or bfloat16, got {x.dtype}")
    _check(w.dtype == x.dtype and b.dtype == x.dtype,
           f"mixed types {x.dtype}, {w.dtype}, {b.dtype}")
    return FusedDenseLReLU.apply(x, w, b, float(slope))


fused_dense_lrelu.launches = 0
