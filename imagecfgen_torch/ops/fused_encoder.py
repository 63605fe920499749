"""The BiGAN encoder trunk (a stack of strided convs with bias and LeakyReLU)
as one hand-written CUDA kernel per layer, with its plain PyTorch version.

Port of ``imagecfgen_tpu/ops/pallas/fused_encoder.py``. The CUDA source,
``csrc/fused_encoder.cu``, is an implicit-GEMM conv with the bias and
LeakyReLU in its epilogue; its header states the bound on the card and what
the design does about it.

``fused_encoder_forward`` launches the kernel for CUDA tensors (or raises)
and runs the plain version for CPU tensors; nothing falls back. Its
``launches`` attribute counts the calls that reached the kernel.
"""
from __future__ import annotations

import ctypes
from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F

from ._build import load_library
from .conv import conv_out_size

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
    ``(Cout, Cin*k*k)`` kernel, plus bias, then LeakyReLU — the kernel's
    implicit GEMM written out."""
    x = x.permute(0, 3, 1, 2)
    for (stride, pad, slope), (w, b) in zip(conv_ops, weights):
        bsz, _, h, wd = x.shape
        co, _, k, _ = w.shape
        oh, ow = conv_out_size(h, k, stride, pad), conv_out_size(wd, k, stride, pad)
        cols = F.unfold(x, k, padding=pad, stride=stride)
        x = (w.reshape(co, -1) @ cols + b[:, None]).reshape(bsz, co, oh, ow)
        if slope is not None:
            x = torch.where(x >= 0, x, slope * x)
    return x.permute(0, 2, 3, 1)


def fused_encoder_reference(feats: torch.Tensor, weights, conv_ops) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) features -> (B, latent).
    ``weights``: ``[(kernel (O, I, k, k), bias (O,)), ...]`` in layer order."""
    x = _plain_layers(feats, weights, conv_ops)
    return x.reshape(x.shape[0], -1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_encoder_forward: {msg}")


def _kernel_entry():
    """The C entry point of ``csrc/fused_encoder.cu``, built at first use."""
    fn = load_library("fused_encoder").fused_encoder_run
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
    ]
    return fn


def _launch(feats: torch.Tensor, pairs, conv_ops, first: int) -> torch.Tensor:
    bsz, h, w, c = feats.shape
    n = len(conv_ops)
    _check(feats.dtype == torch.float32, f"takes float32, got {feats.dtype}")
    _check(feats.is_contiguous(), "features must be contiguous NHWC")
    flat, outs, ints, slopes = [], [None] * n, [], []
    for i, ((stride, pad, slope), (wt, b)) in enumerate(zip(conv_ops, pairs)):
        co, ci, kh, kw = wt.shape
        _check(kh == kw and 1 <= kh <= 5, f"layer {i}: kernel {kh}x{kw} not square in 1..5")
        _check(isinstance(stride, int) and isinstance(pad, int), f"layer {i}: stride/pad must be ints")
        ints += [kh, stride, pad, co, int(slope is not None)]
        slopes.append(0.0 if slope is None else float(slope))
        if i < first:
            flat += [None, None]
            continue
        _check(ci == c, f"layer {i}: kernel takes {ci} channels, input has {c}")
        for t in (wt, b):
            _check(t.device == feats.device and t.dtype == torch.float32,
                   f"layer {i}: weights must be float32 on {feats.device}")
        flat += [wt.permute(2, 3, 1, 0).contiguous(), b.contiguous()]
        h, w, c = conv_out_size(h, kh, stride, pad), conv_out_size(w, kh, stride, pad), co
        _check(h > 0 and w > 0, f"layer {i}: empty output")
        outs[i] = torch.empty((bsz, h, w, c), device=feats.device, dtype=torch.float32)
    if bsz == 0:
        return outs[-1]

    fn = _kernel_entry()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_slopes = (ctypes.c_float * n)(*slopes)
    c_weights = (ctypes.c_void_p * (2 * n))(*[ptr(t) for t in flat])
    c_outs = (ctypes.c_void_p * n)(*[ptr(t) for t in outs])
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        _, fh, fw, fc = feats.shape
        rc = fn(feats.data_ptr(), bsz, fh, fw, fc, n, first, c_ints, c_slopes,
                c_weights, c_outs, stream)
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
    naming); ``plan``: the matching conv plan (e.g.
    ``mnist_bigan_config().enc_plan``). ``split``: run the first ``split``
    convs with the plain version and the rest in the kernel.
    """
    conv_ops = plan_conv_ops(plan)
    flat = trunk_weights(trunk_params)
    _check(len(flat) == 2 * len(conv_ops), f"{len(flat)} tensors for {len(conv_ops)} convs")
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(conv_ops))]
    _check(feats.dim() == 4, f"features must be (B, H, W, C), got {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return fused_encoder_reference(feats, pairs, conv_ops)
    _check(feats.device.type == "cuda", f"no kernel for device {feats.device}")
    _check(0 <= split < len(conv_ops), f"split {split} out of range")
    if split:
        feats = _plain_layers(feats, pairs[:split], conv_ops[:split]).contiguous()
    out = _launch(feats, pairs, conv_ops, split)
    return out.reshape(out.shape[0], -1)


fused_encoder_forward.launches = 0
