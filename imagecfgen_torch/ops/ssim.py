"""SSIM (structural similarity) of NHWC batches (port of
``imagecfgen_tpu/ops/ssim.py``).

An 11x11 Gaussian window (sigma 1.5) applied as two separable depthwise
``VALID`` convolutions (``F.conv2d(..., groups=C)`` on the NCHW view), with
the standard constants ``k1 = 0.01`` and ``k2 = 0.03``. This is plain torch:
the JAX package computes it with ``lax.conv_general_dilated`` and no Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of an NHWC tensor (valid padding)."""
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, win.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    y = F.conv2d(y, win.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM between NHWC batches ``x`` and ``y``: a scalar if
    ``size_average``, else a per-image ``(B,)`` vector."""
    win = _gaussian_kernel(win_size, win_sigma, x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _blur(x * x, win) - mu_xx
    sigma_yy = _blur(y * y, win) - mu_yy
    sigma_xy = _blur(x * y, win) - mu_xy

    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    per_image = ssim_map.mean(dim=(1, 2, 3))
    return per_image.mean() if size_average else per_image
