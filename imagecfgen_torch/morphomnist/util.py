"""Drawing helpers for digits, grids and measured geometry (port of
``imagecfgen_tpu/morphomnist/util.py``: ``plot_digit``, ``plot_grid``,
``plot_ellipse``, ``plot_parallelogram``).

The JAX helpers draw on matplotlib axes; the machine with the card has no
matplotlib, so these rasterise with numpy on the panel conventions of
``cli/common.py``: a panel is an RGB array ``(H, W, 3)`` in [0, 1], and where
the JAX helper takes axes ``ax`` these take such an array, ``canvas``, and
draw on it in place. A canvas holds an image at one pixel a unit: pixel
``canvas[r, c]`` is centred on the point ``(x, y) = (c, r)``, as matplotlib's
``imshow`` places it. Titles are not drawn.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Color = Tuple[float, float, float]


def _gray_r(img: np.ndarray, vmin: Optional[float], vmax: Optional[float]) -> np.ndarray:
    """``imshow(img, cmap="gray_r")``'s colours: ``[vmin, vmax]`` (default
    the image's own range) onto white .. black, as RGB."""
    img = np.asarray(img, np.float64)
    lo = float(img.min()) if vmin is None else vmin
    hi = float(img.max()) if vmax is None else vmax
    v = np.clip((img - lo) / (hi - lo), 0.0, 1.0) if hi > lo else np.zeros_like(img)
    return np.repeat((1.0 - v)[..., None], 3, axis=2)


def plot_digit(img, vmin: Optional[float] = None, vmax: Optional[float] = None, scale: int = 1) -> np.ndarray:
    """``img`` ``(H, W)`` as a gray_r RGB panel ``(H * scale, W * scale, 3)``,
    each pixel enlarged to ``scale`` x ``scale``."""
    panel = _gray_r(np.asarray(img).squeeze(), vmin, vmax)
    return np.repeat(np.repeat(panel, scale, axis=0), scale, axis=1)


def plot_grid(images, n_cols: int = 10) -> np.ndarray:
    """``images`` ``(N, H, W)`` in rows of ``n_cols``, each on its own gray_r
    range (as ``imshow`` scales each axes); unused cells are white. Returns
    the grid's RGB pixels ``(rows * H, n_cols * W, 3)``."""
    images = np.asarray(images)
    n, h, w = images.shape[:3]
    n_rows = (n + n_cols - 1) // n_cols
    grid = np.ones((n_rows * h, n_cols * w, 3))
    for i in range(n):
        r, c = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = _gray_r(images[i], None, None)
    return grid


def _draw(canvas: np.ndarray, x: np.ndarray, y: np.ndarray, color: Color) -> None:
    """Set the pixels nearest the points ``(x, y)`` that lie on the canvas."""
    c, r = np.round(x).astype(int), np.round(y).astype(int)
    ok = (r >= 0) & (r < canvas.shape[0]) & (c >= 0) & (c < canvas.shape[1])
    canvas[r[ok], c[ok]] = color


def _polyline(canvas: np.ndarray, pts: np.ndarray, color: Color) -> None:
    """The segments between consecutive points ``(x, y)``, sampled at most
    a quarter pixel apart."""
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        n = int(np.ceil(4 * max(abs(x1 - x0), abs(y1 - y0)))) + 1
        t = np.linspace(0.0, 1.0, n)
        _draw(canvas, x0 + t * (x1 - x0), y0 + t * (y1 - y0), color)


def ellipse_points(moments, scale: float = 2.0, n: int = 0) -> np.ndarray:
    """Points ``(n, 2)`` of ``(x, y)`` on the second-moment ellipse of an
    ``ImageMoments``: centred on its centroid, semi-axes ``scale`` times its
    axis lengths, the first axis at its angle (``matplotlib.patches.Ellipse``
    ``((cx, cy), 2 scale a, 2 scale b, angle=degrees(angle))``). ``n``: the
    count, by default enough to lie a quarter pixel apart."""
    cx, cy = moments.centroid
    a, b = (scale * v for v in moments.axis_lengths)
    n = n or int(np.ceil(4 * 2 * np.pi * max(a, b, 1.0))) + 1
    t = np.linspace(0.0, 2.0 * np.pi, n)
    cos, sin = np.cos(moments.angle), np.sin(moments.angle)
    ex, ey = a * np.cos(t), b * np.sin(t)
    return np.stack([cx + cos * ex - sin * ey, cy + sin * ex + cos * ey], axis=1)


def plot_ellipse(moments, canvas: np.ndarray, scale: float = 2.0, color: Color = (1.0, 0.0, 0.0)) -> np.ndarray:
    """Draw the outline of :func:`ellipse_points` on ``canvas``; returns it."""
    pts = ellipse_points(moments, scale)
    _draw(canvas, pts[:, 0], pts[:, 1], color)
    return canvas


def plot_parallelogram(corners: Sequence, canvas: np.ndarray, color: Color = (0.0, 0.6, 1.0)) -> np.ndarray:
    """Draw the closed polygon through ``corners`` (``(x, y)`` rows, as
    ``morpho.bounding_parallelogram`` returns them) on ``canvas``; returns
    it."""
    pts = np.asarray(corners, np.float64)
    _polyline(canvas, np.concatenate([pts, pts[:1]]), color)
    return canvas
