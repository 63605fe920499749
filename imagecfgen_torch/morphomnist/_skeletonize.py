"""Medial-axis skeletonization, scikit-image's algorithm (port of
``imagecfgen_tpu/morphomnist/_skeletonize.py``).

The pixels of the binary image are visited in increasing order of
(distance to the boundary, cornerness, tiebreak) and removed unless removal
would change the local 8-connectivity or the pixel has fewer than 3
neighbours. The visit is sequential, so its loop runs in C++.

Two engines give the same skeleton, chosen by the caller and never
swapped behind its back:

- ``"native"`` (the default): the batched C++ engine of
  ``csrc/morphometry.cpp`` (EDT, order and thinning in one call);
- ``"python"``: the executable spec: scipy's EDT, numpy's ``lexsort`` for
  the order and the loop of ``csrc/skeletonize.cpp``, whose own spec is
  :func:`_loop_python`.

Determinism: unlike scikit-image's default (an unseeded random tiebreak),
the tiebreak is splitmix64 of the pixel's linear index, a bijection, so the
visit order is a strict total order that both engines follow. Either C++
library is built with the host compiler at first use; a failed build
raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
from scipy import ndimage as ndi

from ..ops._build import load_host_library

ENGINES = ("native", "python")
_EIGHT = np.ones((3, 3), dtype=int)


def check_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return engine


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 array: a bijection, so distinct linear
    indices get distinct tiebreak keys (the C++ engine's constants)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _pattern(index: int) -> np.ndarray:
    bits = [(index >> b) & 1 for b in range(9)]
    return np.array(bits, dtype=bool).reshape(3, 3)


@lru_cache(maxsize=1)
def _removal_table() -> np.ndarray:
    """``table[idx] == 1``: keep the pixel (its removal would break the
    topology, or it is an end point)."""
    keep = np.zeros(512, dtype=np.uint8)
    for idx in range(512):
        if not (idx & 16):  # the centre must be foreground
            continue
        pat = _pattern(idx)
        pat_wo = pat.copy()
        pat_wo[1, 1] = False
        n_with = ndi.label(pat, _EIGHT)[1]
        n_without = ndi.label(pat_wo, _EIGHT)[1]
        if n_with != n_without or pat.sum() < 3:
            keep[idx] = 1
    return keep


def _loop_lib() -> ctypes.CDLL:
    lib = load_host_library("skeletonize")
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.skeletonize_loop.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
                                     ctypes.c_int32, u8p]
    lib.skeletonize_loop.restype = None
    return lib


def _loop_native(img: np.ndarray, ii, jj, order, table) -> None:
    """The thinning loop of ``csrc/skeletonize.cpp``, in place on ``img``."""
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    _loop_lib().skeletonize_loop(
        img.ctypes.data_as(u8p), img.shape[0], img.shape[1], ii.ctypes.data_as(i32p),
        jj.ctypes.data_as(i32p), order.ctypes.data_as(i32p), len(order), table.ctypes.data_as(u8p))


def _loop_python(img: np.ndarray, ii, jj, order, table) -> None:
    """The same loop in Python: the spec of ``csrc/skeletonize.cpp``."""
    h, w = img.shape
    for o in order:
        i, j = int(ii[o]), int(jj[o])
        idx = 0
        bit = 0
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                y, x = i + di, j + dj
                if 0 <= y < h and 0 <= x < w and img[y, x]:
                    idx |= 1 << bit
                bit += 1
        if not table[idx]:
            img[i, j] = 0


def thinning_order(binary: np.ndarray, distance: np.ndarray):
    """``(ii, jj, order)``: the foreground pixels' coordinates and the
    order in which the loop visits them."""
    nbh_count = ndi.correlate(binary.astype(np.int32), np.ones((3, 3), np.int32), mode="constant")
    corner_score = 9 - nbh_count  # fewer neighbours: more of a corner, visited later
    ii, jj = np.nonzero(binary)
    tiebreak = _splitmix64(ii.astype(np.uint64) * np.uint64(binary.shape[1]) + jj.astype(np.uint64))
    order = np.lexsort((tiebreak, corner_score[binary], distance[binary])).astype(np.int32)
    return np.ascontiguousarray(ii, np.int32), np.ascontiguousarray(jj, np.int32), order


def medial_axis(binary: np.ndarray, return_distance: bool = False, seed: int = 0,
                engine: str = "native"):
    """Medial-axis skeleton of a 2-D binary image (and its distance map).
    ``seed`` is accepted for scikit-image's signature: the tiebreak is fixed
    (see the module's docstring)."""
    check_engine(engine)
    binary = np.ascontiguousarray(np.asarray(binary).astype(bool))
    if engine == "native":
        from .engine import morphometry_batch

        dist, skel, _ = morphometry_batch(binary[None], want_distance=return_distance,
                                          want_skeleton=True, want_metrics=False)
        return (skel[0], dist[0]) if return_distance else skel[0]

    distance = ndi.distance_transform_edt(binary)
    ii, jj, order = thinning_order(binary, distance)
    img = np.ascontiguousarray(binary.astype(np.uint8))
    _loop_native(img, ii, jj, order, _removal_table())
    skel = img.astype(bool)
    return (skel, distance) if return_distance else skel
