"""Morphological pipeline and image moments, on the host (port of
``imagecfgen_tpu/morphomnist/morpho.py``, numpy and scipy only).

The measurement core of the reference's vendored Morpho-MNIST library
(``morphomnist/morpho.py``) without scikit-image:

- Gaussian-pyramid upscale/downscale (cubic spline zoom + smoothing),
- binarisation at a relative threshold,
- medial-axis skeleton + Euclidean distance map (see ``_skeletonize``; the
  engine, ``"native"`` or ``"python"``, is the caller's choice),
- derived morphometrics: area, stroke length (sqrt-2-weighted skeleton
  adjacency), mean thickness (2x mean skeleton distance),
- first/second image moments, shear, bounding parallelogram.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage as ndi

from ._skeletonize import medial_axis

# skeleton-length correlation mask: straight neighbours count 1, diagonal
# neighbours sqrt(2); correlating over the lower half avoids double counting
# (reference morphomnist/morpho.py:7,64-70)
_SKEL_LEN_MASK = np.array(
    [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [np.sqrt(2.0), 1.0, np.sqrt(2.0)]]
)


def _pyramid_sigma(scale: float) -> float:
    return 2.0 * scale / 6.0


def pyramid_expand(image: np.ndarray, upscale: int, order: int = 3) -> np.ndarray:
    """Upsample by ``upscale`` with cubic interpolation + Gaussian smoothing
    (scikit-image ``pyramid_expand`` semantics: resize then smooth)."""
    img = np.asarray(image, dtype=np.float64)
    out = ndi.zoom(img, upscale, order=order, mode="reflect", grid_mode=True)
    return ndi.gaussian_filter(out, _pyramid_sigma(upscale), mode="reflect")


def pyramid_reduce(image: np.ndarray, downscale: int, order: int = 3) -> np.ndarray:
    """Smooth then downsample by ``downscale`` (``pyramid_reduce``).

    Output size is ``ceil(n / downscale)`` per axis — the upstream
    convention. ``ndi.zoom(..., 1/downscale)`` alone ROUNDS instead
    (65/16 -> 4, not 5), which made the SetThickness disk cache an
    even-sized, asymmetric footprint: every synthesized dilation/erosion
    drifted the glyph by half a pixel (caught by the hand-derived
    thickness goldens in tests/test_morpho_golden.py). For divisible
    sizes (the downscale() path) both conventions agree.
    """
    img = np.asarray(image, dtype=np.float64)
    sm = ndi.gaussian_filter(img, _pyramid_sigma(downscale), mode="reflect")
    out_shape = tuple(int(np.ceil(s / downscale)) for s in img.shape)
    zoom_f = [o / s for o, s in zip(out_shape, img.shape)]
    return ndi.zoom(sm, zoom_f, order=order, mode="reflect", grid_mode=True)


def _process_img_morph(img: np.ndarray, threshold: float = 0.5, scale: int = 1,
                       engine: str = "native"):
    if scale > 1:
        up = pyramid_expand(img / max(img.max(), 1e-12), upscale=scale)
        up = np.clip(up, 0.0, 1.0)
        img = (255.0 * up).astype(np.asarray(img).dtype)
    img_min, img_max = img.min(), img.max()
    bin_img = img >= img_min + (img_max - img_min) * threshold
    skel, dist = medial_axis(bin_img, return_distance=True, engine=engine)
    return img, bin_img, skel, dist


class ImageMorphology:
    """Upscaled/binarised image with skeleton and distance map.

    API-compatible with the reference ``ImageMorphology``
    (``morphomnist/morpho.py:20-102``): exposes ``hires_image``,
    ``binary_image``, ``skeleton``, ``distance_map``, ``area``,
    ``stroke_length``, ``mean_thickness``, ``downscale``. ``engine`` picks
    the skeleton's engine (``_skeletonize.medial_axis``).
    """

    def __init__(self, image, threshold: float = 0.5, scale: int = 1, engine: str = "native"):
        self.image = np.asarray(image)
        self.threshold = threshold
        self.scale = scale
        self.engine = engine
        (
            self.hires_image,
            self.binary_image,
            self.skeleton,
            self.distance_map,
        ) = _process_img_morph(self.image, threshold, scale, engine)

    @property
    def area(self) -> float:
        return float(self.binary_image.sum()) / self.scale**2

    @property
    def stroke_length(self) -> float:
        skel = self.skeleton.astype(float)
        conv = ndi.correlate(skel, _SKEL_LEN_MASK, mode="constant")
        return float((conv * skel).sum()) / self.scale

    @property
    def mean_thickness(self) -> float:
        if not self.skeleton.any():
            return 0.0
        return float(2.0 * np.mean(self.distance_map[self.skeleton]) / self.scale)

    @property
    def median_thickness(self) -> float:
        if not self.skeleton.any():
            return 0.0
        return float(2.0 * np.median(self.distance_map[self.skeleton]) / self.scale)

    def downscale(self, image) -> np.ndarray:
        """Amplitude-preserving pyramid reduce. Returns float32 — the
        perturbation outputs are binary [0, 1] images, and a uint8 cast
        here would quantise them to {0, 1}/255 (i.e. black)."""
        image = np.asarray(image, dtype=np.float64)
        if self.scale > 1:
            down = pyramid_reduce(image / max(image.max(), 1e-12), self.scale)
            down = np.clip(down, 0.0, 1.0) * image.max()
        else:
            down = image
        return down.astype(np.float32)


class ImageMoments:
    """First- and second-order central moments of a 2-D image
    (reference ``morphomnist/morpho.py:105-175``)."""

    def __init__(self, img: np.ndarray):
        img = np.asarray(img, dtype=float)
        x = np.arange(img.shape[1])[None, :]
        y = np.arange(img.shape[0])[:, None]
        m00 = img.sum()
        m10 = float((x * img).sum() / m00)
        m01 = float((y * img).sum() / m00)
        self.m00 = float(m00)
        self.m10 = m10
        self.m01 = m01
        self.u20 = float((x**2 * img).sum() / m00) - m10**2
        self.u11 = float((x * y * img).sum() / m00) - m10 * m01
        self.u02 = float((y**2 * img).sum() / m00) - m01**2

    @property
    def centroid(self) -> Tuple[float, float]:
        return self.m10, self.m01

    @property
    def covariance(self) -> Tuple[float, float, float]:
        return self.u20, self.u11, self.u02

    @property
    def axis_lengths(self) -> Tuple[float, float]:
        delta = 0.5 * np.hypot(2.0 * self.u11, self.u20 - self.u02)
        mid = 0.5 * (self.u20 + self.u02)
        return float(np.sqrt(max(mid + delta, 0.0))), float(np.sqrt(max(mid - delta, 0.0)))

    @property
    def angle(self) -> float:
        return float(0.5 * np.arctan2(2.0 * self.u11, self.u20 - self.u02))

    @property
    def horizontal_shear(self) -> float:
        return self.u11 / self.u02

    @property
    def vertical_shear(self) -> float:
        return self.u11 / self.u20


def bounding_parallelogram(img, frac: float, moments: ImageMoments = None):
    """Shear-corrected bounding parallelogram discarding ``frac`` of the
    image mass per side (reference ``morphomnist/morpho.py:178-233``);
    returns corners clockwise from top-left as (x, y) arrays."""
    img = np.asarray(img, dtype=float)
    height, width = img.shape
    x = np.arange(width)[None, :]
    y = np.arange(height)[:, None]

    if moments is None:
        moments = ImageMoments(img)
    y_mid = moments.centroid[1]
    shear = moments.horizontal_shear
    total = img.sum()

    # CDF of mass left of a sheared vertical line, per integer offset:
    # hcdf[t] = sum of img where sheared_x < t. Binning each pixel at
    # floor(sheared_x)+1 (the first integer t strictly greater) and
    # cumulative-summing is equivalent to the reference's per-t scan in
    # O(HW) instead of O(W*HW).
    hlocs = np.arange(width)
    sheared_x = x + 0.5 - shear * (y - y_mid)  # compare against t
    first_t = np.clip(np.floor(sheared_x).astype(np.int64) + 1, 0, width)
    mass = np.bincount(first_t.ravel(), weights=np.broadcast_to(img, first_t.shape).ravel(), minlength=width + 1)
    hcdf = np.cumsum(mass)[:width] / total
    row_mass = img.sum(axis=1)
    vcdf = np.concatenate([[0.0], np.cumsum(row_mass)[: height - 1]]) / total

    frac = frac / 2.0  # two-sided
    left, right = np.interp([frac, 1.0 - frac], hcdf, hlocs)
    top, bottom = np.interp([frac, 1.0 - frac], vcdf, np.arange(height))

    top_left = np.array([left + shear * (top - y_mid), top])
    top_right = np.array([right + shear * (top - y_mid), top])
    bottom_left = np.array([left + shear * (bottom - y_mid), bottom])
    bottom_right = np.array([right + shear * (bottom - y_mid), bottom])
    return top_left, top_right, bottom_right, bottom_left
