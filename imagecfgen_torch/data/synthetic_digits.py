"""Procedural 28x28 digit-like glyphs: a stand-in for MNIST where none is at
hand (a copy of ``imagecfgen_tpu/data/synthetic_digits.py``: the same images
from the same seed).

Each class is a polyline skeleton rendered with a soft pen, with per-sample
jitter. The glyphs have the properties the pipeline exercises — a connected
bright stroke with measurable thickness, slant and width, class-distinguishable
shapes — so datasets, classifiers and CF metrics run end to end without real
MNIST. Real IDX data is read by :func:`..data.mnist.load_raw_mnist`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# polyline skeletons per digit class in a 0..1 box, (x, y) with y down
_STROKES = {
    0: [[(0.5, 0.1), (0.8, 0.3), (0.8, 0.7), (0.5, 0.9), (0.2, 0.7), (0.2, 0.3), (0.5, 0.1)]],
    1: [[(0.35, 0.25), (0.55, 0.1), (0.55, 0.9)]],
    2: [[(0.2, 0.3), (0.45, 0.1), (0.75, 0.3), (0.3, 0.65), (0.2, 0.9), (0.8, 0.9)]],
    3: [[(0.25, 0.15), (0.7, 0.2), (0.45, 0.45), (0.75, 0.65), (0.45, 0.9), (0.2, 0.8)]],
    4: [[(0.65, 0.9), (0.65, 0.1), (0.2, 0.6), (0.85, 0.6)]],
    5: [[(0.75, 0.1), (0.3, 0.1), (0.25, 0.5), (0.65, 0.45), (0.75, 0.7), (0.5, 0.9), (0.25, 0.85)]],
    6: [[(0.7, 0.12), (0.35, 0.35), (0.25, 0.7), (0.5, 0.9), (0.72, 0.7), (0.55, 0.5), (0.3, 0.6)]],
    7: [[(0.2, 0.12), (0.8, 0.12), (0.45, 0.9)]],
    8: [[(0.5, 0.1), (0.72, 0.27), (0.5, 0.48), (0.28, 0.27), (0.5, 0.1)],
        [(0.5, 0.48), (0.75, 0.7), (0.5, 0.92), (0.25, 0.7), (0.5, 0.48)]],
    9: [[(0.7, 0.4), (0.45, 0.5), (0.3, 0.3), (0.5, 0.1), (0.7, 0.25), (0.68, 0.6), (0.55, 0.9)]],
}


def _render(points: np.ndarray, size: int, pen: float) -> np.ndarray:
    """Render a polyline with a Gaussian pen onto a size x size canvas."""
    canvas = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for a, b in zip(points[:-1], points[1:]):
        seg = b - a
        seg_len = max(np.hypot(*seg), 1e-6)
        n = max(int(seg_len * 2), 2)
        for t in np.linspace(0.0, 1.0, n):
            cx, cy = a + t * seg
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            np.maximum(canvas, np.exp(-d2 / (2.0 * pen**2)), out=canvas)
    return canvas


def synthetic_digits(
    n: int, seed: int = 0, size: int = 28
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, 28, 28) float32 in [0, 255], labels (n,) int64)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = np.zeros((n, size, size), np.float32)
    for k in range(n):
        cls = int(labels[k])
        scale = size * rng.uniform(0.8, 0.95)
        offset = (size - scale) / 2 + rng.uniform(-1.0, 1.0, 2)
        shear = rng.uniform(-0.15, 0.15)
        pen = rng.uniform(0.8, 1.4)
        img = np.zeros((size, size), np.float32)
        for stroke in _STROKES[cls]:
            pts = np.asarray(stroke, np.float32).copy()
            pts += rng.normal(0, 0.015, pts.shape)
            pts[:, 0] += shear * (0.5 - pts[:, 1])  # slant jitter
            pts = pts * scale + offset
            np.maximum(img, _render(pts, size, pen), out=img)
        images[k] = np.clip(img, 0, 1) * 255.0
    return images, labels
