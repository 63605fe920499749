"""The batched native morphometry engine (port of
``imagecfgen_tpu/morphomnist/engine.py``).

Wraps ``csrc/morphometry.cpp``: exact EDT, deterministic medial-axis
thinning and the skeleton metrics' sums, threaded over the batch in C++.
Its removal order is the python engine's (``_skeletonize.medial_axis``, the
same splitmix64 tiebreak), so the two give the same skeletons and hence the
same metrics. The library is built with the host compiler at first use; a
build or load failure raises, and no caller falls back to the other engine.

``measure_batch_native`` is ``measure.measure_batch(engine="native")``: the
reference parallelises measurement with a ``multiprocessing.Pool`` over
per-image Python work (its ``morphomnist/measure.py:119-122``); here the
upsampling runs in a thread pool (scipy releases the GIL) and everything
after binarisation is one native call.
"""
from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops._build import load_host_library
from ._skeletonize import _removal_table
from .morpho import ImageMoments, bounding_parallelogram, pyramid_expand

COLUMNS = ("area", "length", "thickness", "slant", "width", "height")


@lru_cache(maxsize=1)
def _native_lib() -> ctypes.CDLL:
    lib = load_host_library("morphometry")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.morphometry_batch.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, f64p, u8p, f64p, ctypes.c_int32,
    ]
    lib.morphometry_batch.restype = None
    return lib


def _as_u8p(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.POINTER(ctypes.c_uint8)()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_f64p(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.POINTER(ctypes.c_double)()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def morphometry_batch(
    binary: np.ndarray,
    want_distance: bool = False,
    want_skeleton: bool = False,
    want_metrics: bool = True,
    n_threads: Optional[int] = None,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """EDT, skeleton and metrics of a (B, H, W) binary batch.

    Returns (distance (B,H,W) f64 | None, skeleton (B,H,W) bool | None,
    metrics (B,4) f64 [area_px, stroke_len_px, mean_skel_dist, skel_count]
    | None)."""
    lib = _native_lib()
    binary = np.ascontiguousarray(binary.astype(np.uint8))
    b, h, w = binary.shape
    dist = np.empty((b, h, w), np.float64) if want_distance else None
    skel = np.empty((b, h, w), np.uint8) if want_skeleton else None
    metrics = np.empty((b, 4), np.float64) if want_metrics else None
    table = np.ascontiguousarray(_removal_table())
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, b)
    lib.morphometry_batch(
        _as_u8p(binary), b, h, w, _as_u8p(table), _as_f64p(dist), _as_u8p(skel), _as_f64p(metrics),
        n_threads,
    )
    return dist, (skel.astype(bool) if skel is not None else None), metrics


def measure_batch_native(
    images: np.ndarray,
    threshold: float = 0.5,
    scale: int = 4,
    bound_frac: float = 0.02,
    workers: Optional[int] = None,
    chunk: int = 256,
) -> Dict[str, np.ndarray]:
    """The morphometrics of a batch, the values of ``measure_image``, as
    float64 columns ``COLUMNS`` (in that order).

    Upsampling (scipy zoom + gaussian) runs in a thread pool; EDT, skeleton,
    area, length and thickness in the C++ engine; the moments and the
    bounding parallelogram (cheap) per image in numpy.
    """
    images = np.asarray(images)
    n = len(images)
    workers = workers or min(os.cpu_count() or 1, 16)

    def upsample(img):
        if scale > 1:
            up = pyramid_expand(img / max(img.max(), 1e-12), upscale=scale)
            return (255.0 * np.clip(up, 0.0, 1.0)).astype(img.dtype)
        return img

    def tail_metrics(args):
        im, (area_px, length_px, mean_d, _count) = args
        moments = ImageMoments(im)
        slant = float(np.arctan(-moments.horizontal_shear))
        corners = bounding_parallelogram(im, bound_frac, moments)
        width = (corners[1][0] - corners[0][0]) / scale
        height = (corners[-1][1] - corners[0][1]) / scale
        return (area_px / scale**2, length_px / scale, 2.0 * mean_d / scale, slant,
                float(width), float(height))

    rows = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for lo in range(0, n, chunk):
            hires = list(pool.map(upsample, images[lo:lo + chunk]))
            binary = np.stack([
                im >= float(im.min()) + (float(im.max()) - float(im.min())) * threshold
                for im in hires
            ])
            _, _, metrics = morphometry_batch(binary, n_threads=workers)
            rows.extend(pool.map(tail_metrics, zip(hires, metrics)))
    table = np.asarray(rows, np.float64).reshape(n, len(COLUMNS))
    return {name: table[:, k].copy() for k, name in enumerate(COLUMNS)}
