"""Skeleton utilities: local angles, neighbour counts, location sampling
(port of ``imagecfgen_tpu/morphomnist/skeleton.py``).

The reference's ``morphomnist/skeleton.py`` (used by the Fracture and
Swelling perturbations): estimate the local stroke angle from moments of a
skeleton window, count neighbours, erase around tips/forks, and sample
random skeleton locations with optional pruning.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage as ndi

from .morpho import ImageMoments, ImageMorphology

_NB_MASK = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], int)


def disk(radius: int, dtype=np.uint8) -> np.ndarray:
    """Flat disk structuring element of the given radius."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y <= r * r).astype(dtype)


def get_angle(skel, i: int, j: int, r: int) -> float:
    """Local angle of the skeleton inside a (2r+1)-square window at (i, j)."""
    skel = np.asarray(skel)
    skel = np.pad(skel, pad_width=r, mode="constant", constant_values=0)
    nbs = skel[i : i + 2 * r + 1, j : j + 2 * r + 1]
    return ImageMoments(nbs.astype(float)).angle


def num_neighbours(skel) -> np.ndarray:
    """Number of 8-neighbours at each skeleton pixel (0 elsewhere)."""
    skel = np.asarray(skel, dtype=int)
    return ndi.convolve(skel, _NB_MASK, mode="constant") * skel


def erase(skel, seeds, r: int) -> np.ndarray:
    """Erase a disk of radius ``r`` around each seed location."""
    erased = np.pad(np.asarray(skel), pad_width=r, mode="constant", constant_values=0)
    brush = ~disk(r).astype(bool)
    for i, j in zip(*np.where(seeds)):
        erased[i : i + 2 * r + 1, j : j + 2 * r + 1] &= brush
    return erased[r:-r, r:-r]


class LocationSampler:
    """Sample random pixel locations along a skeleton, avoiding tips/forks.
    ``sample`` draws from ``rng`` (a ``np.random.RandomState``), by default
    numpy's global state as the JAX package does: ``np.random.seed(k)``
    before each package's call gives both the same draws."""

    def __init__(self, prune_tips: float = None, prune_forks: float = None):
        self.prune_tips = prune_tips
        self.prune_forks = prune_forks

    def sample(self, morph: ImageMorphology, num: int = None,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        skel = morph.skeleton
        if self.prune_tips is not None:
            skel = erase(skel, num_neighbours(skel) == 1, int(self.prune_tips * morph.scale))
        if self.prune_forks is not None:
            skel = erase(skel, num_neighbours(skel) == 3, int(self.prune_forks * morph.scale))
        coords = np.array(np.where(skel)).T
        if coords.shape[0] == 0:
            raise ValueError("Overpruned skeleton")
        idx = (np.random if rng is None else rng).choice(coords.shape[0], size=num)
        return coords[idx]
