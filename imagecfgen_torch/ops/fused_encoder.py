"""The BiGAN encoder trunk (a stack of strided convs with bias and LeakyReLU)
as one hand-written CUDA kernel per layer, with its plain PyTorch version.

Port of ``imagecfgen_tpu/ops/pallas/fused_encoder.py``. The CUDA source,
``csrc/fused_encoder.cu`` (main loop in ``csrc/tc_gemm.cuh``), is an
implicit-GEMM conv on the tensor cores with the bias and LeakyReLU in its
epilogue; its header states the bound on the card and what the design does
about it. Like the TPU kernel it takes float32 or bfloat16 tensors (features
and weights of one type), accumulates in float32 and rounds once per layer,
after the bias and LeakyReLU. float32 tensors go through 3xTF32 (hi/lo
split operands, three products), never through single-pass TF32.

``fused_encoder_forward`` launches the kernel for CUDA tensors (or raises)
and runs the plain version for CPU tensors; nothing falls back. The kernel
has no backward, as the TPU kernel has no VJP: asked for a gradient off the
CPU, the function raises rather than return a result that silently carries
none (``models.bigan.Encoder`` takes its differentiable route then). Its
``launches`` attribute counts the calls that reached the kernel. The packed
weights (K-major, split for float32) are made once per parameter and kept
until the parameter changes (``tensor_core.cached``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Mapping, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ._build import load_library
from .conv import conv_out_size
from .tensor_core import (
    DTYPES,
    GemmPlan,
    WindowPlan,
    aligned16,
    cached,
    fit_window,
    pack_conv_weight,
    padded_depth,
    plan_gemm,
    slice_depth,
    sm_count,
)

ConvOp = Tuple[int, int, object]  # (stride, padding, lrelu slope or None)


def plan_conv_ops(plan) -> Tuple[ConvOp, ...]:
    """Extract ((stride, pad, lrelu_slope|None), ...) from a conv-only
    PlanSequential plan; raises if the plan has non-conv/lrelu ops."""
    ops = []
    pending = None
    for op in plan:
        if op[0] == "conv":
            if pending is not None:
                ops.append(pending)
            pending = (op[3], op[4], None)
        elif op[0] == "lrelu":
            if pending is None:
                raise ValueError("lrelu before first conv")
            pending = (pending[0], pending[1], float(op[1]))
        else:
            raise ValueError(f"unsupported op for fused encoder: {op[0]}")
    if pending is not None:
        ops.append(pending)
    return tuple(ops)


def trunk_weights(trunk_params: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """Flatten PlanSequential conv params (conv_i_kernel / conv_i_bias) in
    layer order."""
    out = []
    i = 0
    while f"conv_{i}_kernel" in trunk_params:
        out.append(trunk_params[f"conv_{i}_kernel"])
        out.append(trunk_params[f"conv_{i}_bias"])
        i += 1
    return out


def _plain_layers(x: torch.Tensor, weights, conv_ops) -> torch.Tensor:
    """NHWC in, NHWC out: each conv as im2col (``F.unfold``) times the
    ``(Cout, Cin*k*k)`` kernel, plus bias, then LeakyReLU: the kernel's
    implicit GEMM written out. bfloat16 tensors keep the kernel's
    semantics on any CPU: each layer is computed in float32 from the
    bfloat16 values and rounded once, after the bias and LeakyReLU."""
    dtype = x.dtype
    x = x.permute(0, 3, 1, 2)
    for (stride, pad, slope), (w, b) in zip(conv_ops, weights):
        bsz, _, h, wd = x.shape
        co, _, k, _ = w.shape
        oh, ow = conv_out_size(h, k, stride, pad), conv_out_size(wd, k, stride, pad)
        cols = F.unfold(x.float(), k, padding=pad, stride=stride)
        x = (w.float().reshape(co, -1) @ cols + b.float()[:, None]).reshape(bsz, co, oh, ow)
        if slope is not None:
            x = torch.where(x >= 0, x, slope * x)
        x = x.to(dtype)
    return x.permute(0, 2, 3, 1)


def fused_encoder_reference(feats: torch.Tensor, weights, conv_ops) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) features -> (B, latent).
    ``weights``: ``[(kernel (O, I, k, k), bias (O,)), ...]`` in layer order."""
    x = _plain_layers(feats, weights, conv_ops)
    return x.reshape(x.shape[0], -1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_encoder_forward: {msg}")


def trunk_launch_plan(in_shape: Sequence[int], kernel_shapes, conv_ops, dtype: torch.dtype,
                      sms: int) -> List[Union[GemmPlan, WindowPlan]]:
    """The launch plan of every layer of a trunk: ``in_shape`` is the
    (B, H, W, C) of the features, ``kernel_shapes`` the (O, I, k, k) of each
    conv. A layer whose input channels are a multiple of the slice depth
    runs ``conv_wgmma`` (a :class:`GemmPlan`); any other (a trunk's first,
    or a later one of a narrow trunk) runs ``conv_window`` (a
    :class:`WindowPlan`) where its block fits shared memory, and else
    ``conv_wgmma`` on its input padded with zero channels to the next
    multiple (the plan's ``cin``; the layer before writes them, from zero
    weights and bias, and a trunk's input is copied). A pure function, so
    it can be read without a card."""
    bsz, h, w, _ = in_shape
    bk = slice_depth(dtype)
    plans = []
    for (stride, pad, _), (co, ci, k, _) in zip(conv_ops, kernel_shapes):
        oh, ow = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad)
        plan = fit_window(bsz, h, w, ci, k, stride, pad, dtype) if ci % bk else None
        if plan is None:
            cin = -(-ci // bk) * bk
            plan = plan_gemm(bsz * oh * ow, co, k * k * cin, cin, dtype, sms)
        plans.append(plan)
        h, w = oh, ow
    return plans


@torch.no_grad()
def padded_kernel(wt: torch.Tensor, co: int, ci: int) -> torch.Tensor:
    """An (O, I, k, k) conv kernel with zero output channels up to ``co``
    and zero input channels up to ``ci``. With its bias padded with zeros,
    the channels it adds write zero (LeakyReLU(0) = 0), and those it reads
    add nothing."""
    return F.pad(wt, (0, 0, 0, 0, 0, ci - wt.shape[1], 0, co - wt.shape[0]))


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of ``csrc/fused_encoder.cu``, built at first use."""
    fn = load_library("fused_encoder").fused_encoder_run
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
    ]
    return fn


@functools.lru_cache(maxsize=None)
def _recipe(in_shape, kernel_shapes, conv_ops, first: int, dtype: torch.dtype, sms: int):
    """What a launch needs beside pointers, made once per trunk shape: the
    entry point's integer and slope arrays, each layer's output shape and
    the (output, input) channels each layer's weights are padded to."""
    bsz, h, w, c = in_shape
    plans = trunk_launch_plan(in_shape, kernel_shapes[first:], conv_ops[first:], dtype, sms)
    cins = [p.cin if isinstance(p, GemmPlan) else ks[1] for p, ks in zip(plans, kernel_shapes[first:])]
    ints, slopes, out_shapes, channels = [], [], [], []
    for i, ((stride, pad, slope), (co, ci, k, _)) in enumerate(zip(conv_ops, kernel_shapes)):
        slopes.append(0.0 if slope is None else float(slope))
        if i < first:
            ints += [k, stride, pad, co, int(slope is not None), 0, 0, 1, 1]
            out_shapes.append(None)
            channels.append(None)
            continue
        _check(ci == c, f"layer {i}: kernel takes {ci} channels, input has {c}")
        plan, cin = plans[i - first], cins[i - first]
        cout = cins[i - first + 1] if i + 1 < len(conv_ops) else co
        ints += [k, stride, pad, cout, int(slope is not None), padded_depth(k * k * cin, dtype)]
        ints += ([plan.tile, plan.split, 1] if isinstance(plan, GemmPlan) else [plan.tr, plan.tw, 0])
        h, w, c = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad), co
        _check(h > 0 and w > 0, f"layer {i}: empty output")
        _check(bsz * h * w * cout < 2 ** 31, f"layer {i}: an output of 2^31 elements or more")
        out_shapes.append((bsz, h, w, cout))
        channels.append((cout, cin))
    n = len(conv_ops)
    return ((ctypes.c_int * len(ints))(*ints), (ctypes.c_float * n)(*slopes), tuple(out_shapes),
            tuple(channels))


def _launch(feats: torch.Tensor, pairs, conv_ops, first: int) -> torch.Tensor:
    n = len(conv_ops)
    dtype = feats.dtype
    _check(feats.is_contiguous() and aligned16(feats), "features must be contiguous NHWC, 16-byte aligned")
    _check(feats.numel() < 2 ** 31, "features of 2^31 elements or more")
    c_ints, c_slopes, out_shapes, channels = _recipe(
        tuple(feats.shape), tuple(tuple(wt.shape) for wt, _ in pairs), tuple(conv_ops), first,
        dtype, sm_count(feats.device))
    if channels[first][1] != feats.shape[3]:
        feats = F.pad(feats, (0, channels[first][1] - feats.shape[3])).contiguous()
    ptrs, outs, keep = [], [], []
    for i, (wt, b) in enumerate(pairs):
        if i < first:
            ptrs += [None, None, None]
            outs.append(None)
            continue
        co, ci = channels[i]
        if (co, ci) == tuple(wt.shape[:2]):
            packed, bias = cached(wt, "packed_conv", pack_conv_weight), b.contiguous()
        else:
            packed = cached(wt, f"packed_conv:{co}x{ci}", lambda t: pack_conv_weight(padded_kernel(t, co, ci)))
            bias = cached(b, f"bias:{co}", lambda t: F.pad(t.detach(), (0, co - t.shape[0])))
        keep += [packed, bias]
        ptrs += [packed[0].data_ptr(), packed[1].data_ptr() if len(packed) > 1 else None,
                 bias.data_ptr()]
        outs.append(torch.empty(out_shapes[i], device=feats.device, dtype=dtype))
    bsz, fh, fw, fc = feats.shape
    if bsz == 0:
        return outs[-1]

    fn = _kernel_entry()
    c_weights = (ctypes.c_void_p * (3 * n))(*ptrs)
    c_outs = (ctypes.c_void_p * n)(*[None if t is None else t.data_ptr() for t in outs])
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = fn(feats.data_ptr(), int(dtype == torch.bfloat16), bsz, fh, fw, fc, n, first,
                c_ints, c_slopes, c_weights, c_outs, stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder kernel failed with CUDA error {rc}")
    fused_encoder_forward.launches += 1
    return outs[-1]


def fused_encoder_forward(
    trunk_params: Mapping[str, torch.Tensor],
    feats: torch.Tensor,
    plan,
    split: int = 0,
) -> torch.Tensor:
    """Conv-stack forward: (B, H, W, C) features -> (B, latent).

    ``trunk_params``: the Encoder trunk's parameters (PlanSequential
    naming), float32 or bfloat16 like ``feats``; ``plan``: the matching conv
    plan (e.g. ``mnist_bigan_config().enc_plan``). ``split``: run the first
    ``split`` convs with the plain version and the rest in the kernel.
    """
    conv_ops = plan_conv_ops(plan)
    flat = trunk_weights(trunk_params)
    _check(len(flat) == 2 * len(conv_ops), f"{len(flat)} tensors for {len(conv_ops)} convs")
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(conv_ops))]
    _check(feats.dim() == 4, f"features must be (B, H, W, C), got {tuple(feats.shape)}")
    _check(feats.dtype in DTYPES, f"takes float32 or bfloat16, got {feats.dtype}")
    for i, ((stride, pad, _), (wt, b)) in enumerate(zip(conv_ops, pairs)):
        _check(wt.dim() == 4 and wt.shape[2] == wt.shape[3] and 1 <= wt.shape[2] <= 5,
               f"layer {i}: kernel {tuple(wt.shape)} not square in 1..5")
        _check(isinstance(stride, int) and isinstance(pad, int), f"layer {i}: stride/pad must be ints")
        for t in (wt, b):
            _check(t.dtype == feats.dtype and t.device == feats.device,
                   f"layer {i}: weights are {t.dtype} on {t.device}, features {feats.dtype} on {feats.device}")
    if feats.device.type == "cpu":
        return fused_encoder_reference(feats, pairs, conv_ops)
    wants_grad = torch.is_grad_enabled() and (
        feats.requires_grad or any(t.requires_grad for pair in pairs for t in pair))
    _check(not wants_grad,
           "the kernel has no backward; call it under torch.no_grad() or on detached tensors, "
           "or differentiate the trunk's PlanSequential")
    _check(feats.device.type == "cuda", f"no kernel for device {feats.device}")
    _check(0 <= split < len(conv_ops), f"split {split} out of range")
    if split:
        feats = _plain_layers(feats, pairs[:split], conv_ops[:split]).contiguous()
    out = _launch(feats, pairs, conv_ops, split)
    return out.reshape(out.shape[0], -1)


fused_encoder_forward.launches = 0
