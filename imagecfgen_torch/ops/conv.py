"""Strided conv / transposed-conv primitives with NHWC activations
(port of ``imagecfgen_tpu/ops/conv.py``).

Activations stay NHWC at every public function, as in the JAX package.
Weights are kept in PyTorch's layouts: ``(O, I, kH, kW)`` for a conv and
``(I, O, kH, kW)`` for a transposed conv. ``kernel_from_hwio`` and
``kernel_transpose_from_hwio`` map the JAX package's HWIO kernels onto them.

The JAX transposed conv is an lhs-dilated conv *without* a kernel flip
(``imagecfgen_tpu/ops/conv.py:63-92``), while ``F.conv_transpose2d``
correlates the dilated input with the kernel rotated by 180 degrees; the
flip is therefore baked into the weights by ``kernel_transpose_from_hwio``
and the two functions agree exactly, ``output_padding`` included.

An NHWC tensor permuted to NCHW is a channels-last view, so cuDNN runs
these convs in NHWC without copies.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore


def kernel_from_hwio(w) -> torch.Tensor:
    """JAX conv kernel ``(kH, kW, I, O)`` -> PyTorch ``(O, I, kH, kW)``."""
    return torch.as_tensor(w).permute(3, 2, 0, 1).contiguous()


def kernel_transpose_from_hwio(w) -> torch.Tensor:
    """JAX transposed-conv kernel ``(kH, kW, I, O)`` -> PyTorch
    ``ConvTranspose2d`` layout ``(I, O, kH, kW)``, rotated by 180 degrees."""
    return torch.as_tensor(w).flip(0, 1).permute(2, 3, 0, 1).contiguous()


def conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: IntOr2 = 1, padding: IntOr2 = 0
) -> torch.Tensor:
    """``y[n,h,w,o] = sum_{dh,dw,i} x[n, h*s+dh-p, w*s+dw-p, i] * w[o,i,dh,dw]``;
    out = floor((i + 2p - k)/s) + 1."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=_pair(stride), padding=_pair(padding))
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: IntOr2 = 1,
    padding: IntOr2 = 0,
    output_padding: IntOr2 = 0,
) -> torch.Tensor:
    """Transposed conv, output size ``(i-1)*s - 2p + k + output_padding``."""
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = _pair(padding)
    if kh - 1 - ph < 0 or kw - 1 - pw < 0:
        raise ValueError("padding may not exceed kernel_size - 1")
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2),
        w,
        stride=_pair(stride),
        padding=(ph, pw),
        output_padding=_pair(output_padding),
    )
    return y.permute(0, 2, 3, 1)


def conv_out_size(i: int, k: int, s: int, p: int) -> int:
    return (i + 2 * p - k) // s + 1


def conv_transpose_out_size(i: int, k: int, s: int, p: int, op: int = 0) -> int:
    return (i - 1) * s - 2 * p + k + op
