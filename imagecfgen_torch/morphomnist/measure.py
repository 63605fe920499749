"""Morphometric measurement: area, length, thickness, slant, width, height
(port of ``imagecfgen_tpu/morphomnist/measure.py``).

``measure_image`` returns a :class:`Morphometrics` named tuple, as in the
reference (``morphomnist/measure.py:10-138``). ``measure_batch`` returns a
plain table, a dict of float64 numpy columns ``area, length, thickness,
slant, width, height`` in that order, where the JAX package returns a
pandas ``DataFrame`` (the machine with the card has no pandas).

The engine is chosen by the caller: ``"native"`` (the default) is the
threaded C++ batch engine (``engine.py``), ``"python"`` the per-image numpy
path, the executable spec. Both give the same values (a shared
deterministic thinning order); neither falls back to the other.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from ._skeletonize import check_engine
from .engine import COLUMNS, measure_batch_native
from .morpho import ImageMoments, ImageMorphology, bounding_parallelogram


class Morphometrics(NamedTuple):
    area: float
    length: float
    thickness: float
    slant: float
    width: float
    height: float


def measure_image(
    image,
    threshold: float = 0.5,
    scale: int = 4,
    bound_frac: float = 0.02,
    verbose: bool = True,
    engine: str = "native",
) -> Morphometrics:
    image = np.asarray(image)
    morph = ImageMorphology(image, threshold, scale, engine)
    moments = ImageMoments(morph.hires_image)
    area = morph.area
    length = morph.stroke_length
    thickness = morph.mean_thickness
    slant = float(np.arctan(-moments.horizontal_shear))

    corners = bounding_parallelogram(morph.hires_image, bound_frac, moments)
    width = (corners[1][0] - corners[0][0]) / morph.scale
    height = (corners[-1][1] - corners[0][1]) / morph.scale

    if verbose:
        print(
            f"area={area:.1f} length={length:.1f} thickness={thickness:.2f} "
            f"slant={np.rad2deg(slant):.0f}deg dims={width:.1f}x{height:.1f}"
        )
    return Morphometrics(area, length, thickness, slant, float(width), float(height))


def measure_batch(
    images,
    threshold: float = 0.5,
    scale: int = 4,
    bound_frac: float = 0.02,
    engine: str = "native",
    workers: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """The morphometrics of each image, as float64 columns ``area, length,
    thickness, slant, width, height``. ``workers``: the native engine's
    threads (all cores, at most 16, when None)."""
    images = np.asarray(images)
    if check_engine(engine) == "native":
        return measure_batch_native(images, threshold=threshold, scale=scale, bound_frac=bound_frac,
                                    workers=workers)
    rows = [measure_image(img, threshold, scale, bound_frac, False, "python") for img in images]
    table = np.asarray(rows, np.float64).reshape(len(images), len(COLUMNS))
    return {name: table[:, k].copy() for k, name in enumerate(COLUMNS)}


def as_array(table: Dict[str, np.ndarray]) -> np.ndarray:
    """A ``measure_batch`` table as an ``(N, 6)`` array, columns in order."""
    return np.stack([table[name] for name in COLUMNS], axis=1)
