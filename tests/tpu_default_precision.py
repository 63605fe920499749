"""The port's MNIST and AudioMNIST batteries with the BiGAN computed as a TPU
computes float32 at its default precision: the witness of whether the JAX
package's TPU records (the MNIST hard battery, ``RESULTS.md:454-461``; the
AudioMNIST float32 identity arm, ``RESULTS.md:332-372``) owe their scores to
the TPU's arithmetic.

    python tests/tpu_default_precision.py [DIR] --hard [--seed 1] [--epochs 600] [--resume] [--stages a,b]
    python tests/tpu_default_precision.py --family audio [DIR] [--seed 1] [--resume] [--stages a,b]
    python -m imagecfgen_torch.tools.quality_battery --report DIR_tpu_precision/battery-record.json
    python -m imagecfgen_torch.tools.audio_battery --report DIR/battery-record.json DIR_tpu_precision/battery-record.json

The JAX package asks for no precision anywhere, so on a TPU every float32
convolution and matmul of a program runs at ``lax.Precision.DEFAULT``: one
pass of the matrix unit with both operands rounded to bfloat16, the products
and their sums in float32, a float32 result. That holds for the forward ops
and for the convolutions and matmuls of both gradients alike. Here every
conv, transposed conv and matmul run inside the BiGAN's
``Encoder``, ``Generator`` and ``Discriminator`` (not a subclass's, such as the VAE's
decoder) takes that arithmetic:

- Each of the three modules' ``forward`` marks the witness active while it
  runs. The layer library's two conv functions (``models.layers.conv2d``,
  ``conv_transpose2d``), replaced while the witness is on, then route their
  convs through :class:`_Conv`, which rounds both operands to bfloat16 (in
  float32 tensors), computes in float32, keeps the rounded operands, and
  rounds the incoming gradient before the two backward ops. The plans' dense
  layers (the AudioMNIST generator's stem) go through :func:`_linear` the
  same way (:class:`_Matmul`, as ``jnp.dot`` without a precision runs on a
  TPU): the layer library's ``F.linear`` and ``fused_dense_lrelu`` are
  replaced while the witness is on. The attribute vectors' matmuls run
  inside :class:`TpuDefaultPrecision`, a torch function mode that routes
  ``F.conv2d``, ``F.conv_transpose2d``, ``F.linear`` and the matmuls likewise
  and raises on any other op that multiplies matrices. Only the convs and
  matmuls pay the witness's Python: the host's dispatch bounds the MNIST
  BiGAN's step on the card.
- The encoder's ``fused_encoder`` calls (the training step's recompute and
  every encoding score) run the trunk one conv a launch, each on its rounded
  input and weights (:func:`fused_encoder_by_layer`): each conv's input is
  rounded, as the JAX step's plain trunk rounds it on a TPU
  (``imagecfgen_tpu/train/gan_trainer.py:303``). The kernel's products of
  bfloat16 values are exact and its sums float32, so no kernel changes.

Products of two bfloat16 values are exact in float32, so cuDNN's TF32 convs
(PyTorch's default, which the battery's CLIs keep) compute these ops as a TPU
does, up to the order of the float32 sums. Nothing else changes: batch norm,
the activations, the losses, Adam, the SCM, the classifier and the VAE stay
float32.

The battery runs through its driver's own ``main``, its stages and command
lines (``imagecfgen_torch.tools.quality_battery``; with ``--family audio``,
``imagecfgen_torch.tools.audio_battery`` with the float32 identity arm's
flags, ``--init-std 0.01 --epochs 1200``, and its identity stages), in an
arm directory of its own (``DIR_tpu_precision``, ``DIR_tpu_precision_seedN``)
that shares DIR's data, SCM, classifiers and VAE. The record says
``"tpu_precision"``, and each stage's entry holds the wrapped calls it made by
kind (``tpu_precision_calls``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM = "_tpu_precision"
AUDIO_ARM = ["--init-std", "0.01", "--epochs", "1200"]  # the float32 identity arm's flags
SEMANTICS = {"operands": "bfloat16, round to nearest even", "products_and_sums": "float32",
             "modules": ["Encoder", "Generator", "Discriminator"], "gradients": "the same"}


def _pair(v):  # ``imagecfgen_torch.ops.conv._pair``; the script runs before the repository is on the path
    return (v, v) if isinstance(v, int) else tuple(v)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """A float32 ``t`` rounded to the nearest bfloat16 (ties to even), kept
    float32; any other type as it is."""
    return t.to(torch.bfloat16).to(torch.float32) if t.dtype == torch.float32 else t


class _Conv(torch.autograd.Function):
    """A convolution, plain or transposed (NCHW), of the rounded operands;
    its gradients are the convolutions of the rounded incoming gradient with
    the rounded operands."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed, output_padding):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, transposed, output_padding)
        return torch.ops.aten.convolution(xr, wr, None, stride, padding, [1, 1], transposed,
                                          output_padding, 1)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        stride, padding, transposed, output_padding = ctx.conf
        gx, gw, _ = torch.ops.aten.convolution_backward(
            round_bf16(g), xr, wr, None, stride, padding, [1, 1], transposed, output_padding, 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


class _Matmul(torch.autograd.Function):
    """``a @ b`` (2-D) of the rounded operands, its gradients likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_bf16(g)
        return (gr @ br.t() if ctx.needs_input_grad[0] else None,
                ar.t() @ gr if ctx.needs_input_grad[1] else None)


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if isinstance(padding, str) or _pair(dilation) != (1, 1) or groups != 1:
        raise NotImplementedError("conv2d with string padding, dilation or groups")
    y = _Conv.apply(input, weight, _pair(stride), _pair(padding), False, (0, 0))
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def _conv_transpose2d(input, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                      dilation=1):
    if _pair(dilation) != (1, 1) or groups != 1:
        raise NotImplementedError("conv_transpose2d with dilation or groups")
    y = _Conv.apply(input, weight, _pair(stride), _pair(padding), True, _pair(output_padding))
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def _matmul(a, b):
    if a.dim() != 2 or b.dim() != 2:
        raise NotImplementedError(f"matmul of {a.dim()}-D by {b.dim()}-D")
    return _Matmul.apply(a, b)


def _linear(input, weight, bias=None):
    y = _matmul(input.reshape(-1, input.shape[-1]), weight.t()).reshape(*input.shape[:-1], weight.shape[0])
    return y if bias is None else y + bias


class TpuDefaultPrecision(TorchFunctionMode):
    """Routes the convs and matmuls called inside it through :class:`_Conv`
    and :class:`_Matmul` and tallies them by kind in ``counts``; an op that
    multiplies matrices in any other way raises, so none escapes."""

    ROUTES = {F.conv2d: ("conv", _conv2d), F.conv_transpose2d: ("conv_transpose", _conv_transpose2d),
              F.linear: ("linear", _linear), torch.matmul: ("matmul", _matmul),
              torch.Tensor.matmul: ("matmul", _matmul), torch.Tensor.__matmul__: ("matmul", _matmul),
              torch.mm: ("matmul", _matmul), torch.Tensor.mm: ("matmul", _matmul)}
    REFUSED = {F.conv1d, F.conv3d, F.conv_transpose1d, F.conv_transpose3d, F.bilinear, torch.bmm,
               torch.Tensor.bmm, torch.addmm, torch.Tensor.addmm, torch.baddbmm, torch.addbmm, torch.einsum,
               torch.tensordot, torch.inner, torch.dot, torch.mv, torch.Tensor.__rmatmul__,
               torch.nn.functional.scaled_dot_product_attention}

    def __init__(self, counts: Dict[str, int]):
        super().__init__()
        self.counts = counts

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        route = self.ROUTES.get(func)
        if route is not None:
            kind, fn = route
            self.counts[kind] = self.counts.get(kind, 0) + 1
            return fn(*args, **kwargs)
        if func in self.REFUSED:
            raise NotImplementedError(f"{func.__name__} inside a TPU-precision module")
        return func(*args, **kwargs)


def fused_encoder_by_layer(kernel, counts: Dict[str, int], trunk_params, feats: torch.Tensor, plan,
                           split: int = 0) -> torch.Tensor:
    """``fused_encoder_forward`` (``kernel``) one conv a launch: each conv's
    input and weights rounded (the weights' copies cached per parameter
    version), its LeakyReLU after the launch. Returns the trunk's (B, latent)."""
    from imagecfgen_torch.ops.conv import conv_out_size
    from imagecfgen_torch.ops.tensor_core import cached

    if split:
        raise NotImplementedError("split")
    b, h, w, _ = feats.shape
    x, j = feats, 0
    for op in plan:
        if op[0] == "lrelu":
            x = F.leaky_relu(x, op[1])
            continue
        _, features, k, s, p = op
        one = {"conv_0_kernel": cached(trunk_params[f"conv_{j}_kernel"], "tpu_round", round_bf16),
               "conv_0_bias": trunk_params[f"conv_{j}_bias"]}
        with torch._C.DisableTorchFunction():  # the kernel's own ops, not the module's
            y = kernel(one, round_bf16(x).contiguous(), (op,))
        h, w = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
        x = y.reshape(b, h, w, features)
        counts["encoder_layer"] = counts.get("encoder_layer", 0) + 1
        j += 1
    return x.reshape(b, -1)


def _active_conv(plain, kind, rounded, counts, active):
    """``models.layers``' NHWC conv ``plain``, through :class:`_Conv` while
    ``active[0]`` (a witness module's forward runs)."""
    def conv(x, w, stride=1, padding=0, **kw):
        if not active[0]:
            return plain(x, w, stride, padding, **kw)
        counts[kind] = counts.get(kind, 0) + 1
        return rounded(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding, **kw).permute(0, 2, 3, 1)
    return conv


class _ActiveFunctional:
    """``torch.nn.functional`` as ``models.layers`` sees it under the
    witness: ``linear`` (a plan's dense layer) through :func:`_linear` while
    ``active[0]``, every other name the module's own."""

    def __init__(self, counts: Dict[str, int], active):
        self.counts, self.active = counts, active

    def __getattr__(self, name):
        return getattr(F, name)

    def linear(self, x, w, b=None):
        if not self.active[0]:
            return F.linear(x, w, b)
        self.counts["linear"] = self.counts.get("linear", 0) + 1
        return _linear(x, w, b)


def _active_dense_lrelu(plain, counts, active):
    """``models.layers``' ``fused_dense_lrelu`` ``plain``: a dense layer and
    its LeakyReLU, the layer through :func:`_linear` while ``active[0]``."""
    def dense_lrelu(x, w, b, slope):
        if not active[0]:
            return plain(x, w, b, slope)
        counts["linear"] = counts.get("linear", 0) + 1
        return F.leaky_relu(_linear(x, w, b), slope)
    return dense_lrelu


@contextlib.contextmanager
def tpu_default_precision(counts: Optional[Dict[str, int]] = None):
    """Inside it the BiGAN's E, G and D compute every conv and matmul at a
    TPU's default precision; yields the tally of the wrapped calls."""
    from imagecfgen_torch.models import bigan, layers

    counts = {} if counts is None else counts
    active = [0]  # how many witness modules' forwards are running
    saved = [(cls, cls.forward) for cls in (bigan.Encoder, bigan.Generator, bigan.Discriminator)]
    vectors = layers.AttributeVectors.forward
    kernel, convs = bigan.fused_encoder_forward, (layers.conv2d, layers.conv_transpose2d)
    functional, dense_lrelu = layers.F, layers.fused_dense_lrelu

    def entered(cls, forward):
        @functools.wraps(forward)
        def wrapped(self, *args, **kwargs):
            if type(self) is not cls:  # a subclass, such as the VAE's decoder
                return forward(self, *args, **kwargs)
            active[0] += 1
            try:
                return forward(self, *args, **kwargs)
            finally:
                active[0] -= 1
        return wrapped

    @functools.wraps(vectors)
    def rounded_vectors(self, attrs):
        if not active[0]:
            return vectors(self, attrs)
        with TpuDefaultPrecision(counts):
            return vectors(self, attrs)

    for cls, forward in saved:
        cls.forward = entered(cls, forward)
    layers.AttributeVectors.forward = rounded_vectors
    layers.conv2d = _active_conv(convs[0], "conv", _conv2d, counts, active)
    layers.conv_transpose2d = _active_conv(convs[1], "conv_transpose", _conv_transpose2d, counts, active)
    layers.F = _ActiveFunctional(counts, active)
    layers.fused_dense_lrelu = _active_dense_lrelu(dense_lrelu, counts, active)
    bigan.fused_encoder_forward = functools.partial(fused_encoder_by_layer, kernel, counts)
    try:
        yield counts
    finally:
        for cls, forward in saved:
            cls.forward = forward
        layers.AttributeVectors.forward = vectors
        layers.conv2d, layers.conv_transpose2d = convs
        layers.F, layers.fused_dense_lrelu = functional, dense_lrelu
        bigan.fused_encoder_forward = kernel


@contextlib.contextmanager
def witness_driver(family: str = "mnist"):
    """The battery driver of ``family`` (``quality_battery``, or
    ``audio_battery`` for ``"audio"``) with the witness's arm directory, its
    record key and each stage's tally; yields the driver's module. Both
    drivers run their stages through ``quality_battery``'s runner."""
    sys.path.insert(0, REPO)
    from imagecfgen_torch.tools import audio_battery, quality_battery as qb

    driver = audio_battery if family == "audio" else qb
    arm, run_battery, run_stage = driver.arm_dir, driver.run_battery, qb.run_stage
    counts: Dict[str, int] = {}

    def tallied(stage, args, cwd):
        counts.clear()
        entry = run_stage(stage, args, cwd)
        entry["tpu_precision_calls"] = dict(counts)
        return entry

    driver.arm_dir = lambda args: driver.data_dir(args) + ARM + arm(args)[len(driver.data_dir(args)):]
    driver.run_battery = lambda args, argv, stages, path, header, *rest: run_battery(
        args, argv, stages, path, {**header, "tpu_precision": SEMANTICS}, *rest)
    qb.run_stage = tallied
    try:
        with tpu_default_precision(counts):
            yield driver
    finally:
        driver.arm_dir, driver.run_battery, qb.run_stage = arm, run_battery, run_stage


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--family", choices=("mnist", "audio"), default="mnist")
    args, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.family == "audio":
        rest = AUDIO_ARM + rest  # the arm's flags; a flag given again takes its place
    with witness_driver(args.family) as driver:
        return driver.main(rest)


if __name__ == "__main__":
    sys.exit(main())
