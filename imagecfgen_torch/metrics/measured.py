"""Measured-counterfactual helpers: measure generated images with the
morphometry oracle and compare them with the intervention's targets (port
of ``imagecfgen_tpu/metrics/measured.py``).

Backs the reference's measured-CF scripts (``mnist_gan_measured_cf.py:
91-133``, ``mnist_vae_measured_cf.py:156-262``): regenerate under
do(attr), measure the thickness, intensity and slant of the generated
image, and report the median absolute error against the targets.

``measure_attributes`` measures a batch through the native engine's threads
(``morphomnist.measure.measure_batch``) where the JAX package maps
``measure_image`` over a process pool; it returns what the JAX function
returns. ``engine="python"`` is the per-image numpy path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..morphomnist.measure import measure_batch, measure_image


def _intensity(img: np.ndarray) -> float:
    """The median bright-pixel value (``create_train_dataset.py:82-84``)."""
    lo, hi = img.min(), img.max()
    bright = img[img >= lo + (hi - lo) * 0.5]
    return float(np.median(bright)) if bright.size else 0.0


def measure_attributes_single(image255: np.ndarray, scale: int = 4,
                              engine: str = "native") -> Tuple[float, float, float]:
    """(thickness, intensity, slant) of a [0,255] 28x28 image."""
    img = np.asarray(image255, np.float64)
    m = measure_image(img, scale=scale, verbose=False, engine=engine)
    return float(m.thickness), _intensity(img), float(m.slant)


def measure_attributes(images255: np.ndarray, scale: int = 4, engine: str = "native",
                       workers: Optional[int] = None) -> np.ndarray:
    """(N, 3) float64 array of (thickness, intensity, slant); ``workers``:
    the native engine's threads (all cores, at most 16, when None)."""
    imgs = np.asarray(images255, np.float64)
    if len(imgs) == 0:
        return np.zeros((0, 3), np.float64)
    table = measure_batch(imgs, scale=scale, engine=engine, workers=workers)
    intensity = np.array([_intensity(img) for img in imgs], np.float64)
    return np.stack([table["thickness"], intensity, table["slant"]], axis=1)


def images_to_255(x: np.ndarray) -> np.ndarray:
    """[-1,1] NHWC model output -> [0,255] (N,28,28)."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[..., 0]
    return 255.0 * (x + 1.0) / 2.0


def median_abs_errors(targets: Dict[str, np.ndarray], measured: np.ndarray) -> Dict[str, float]:
    names = ("thickness", "intensity", "slant")
    return {
        k: float(np.median(np.abs(np.asarray(targets[k]).reshape(-1) - measured[:, i])))
        for i, k in enumerate(names)
        if k in targets
    }
