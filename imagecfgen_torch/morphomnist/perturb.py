"""Digit perturbations (port of ``imagecfgen_tpu/morphomnist/perturb.py``):
thinning/thickening/swelling/fracture + the SCM-targeted SetThickness /
SetIntensity / SetSlant / SetWidth operators used by dataset synthesis
(reference ``morphomnist/perturb.py``; ``create_train_dataset.py:79-85``
applies SetThickness -> SetSlant -> intensity rescale).

All operators act on an :class:`ImageMorphology` (hi-res scale) and return
the perturbed hi-res image; morphology is scipy-based (no scikit-image).
Swelling and Fracture draw their locations from numpy's global state, as in
the JAX package (see ``skeleton.LocationSampler``).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

from . import skeleton
from .morpho import ImageMoments, ImageMorphology, bounding_parallelogram, pyramid_reduce
from .skeleton import disk


class Perturbation:
    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        raise NotImplementedError


def _binary_dilation(img: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    if footprint.sum() <= 1:
        return img.astype(bool)
    return ndi.binary_dilation(img, structure=footprint.astype(bool))


def _binary_erosion(img: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    if footprint.sum() <= 1:
        return img.astype(bool)
    return ndi.binary_erosion(img, structure=footprint.astype(bool))


def disk_dilation(img: np.ndarray, radius: float) -> np.ndarray:
    """Binary dilation by a Euclidean disk via the distance transform:
    dilation(img, disk(r)) == {p : EDT(~img)(p) <= r} exactly (both are the
    set of points within distance r of the foreground). O(N) instead of
    O(N * |disk|) — the naive structuring-element dilation dominates
    dataset-synthesis time at the reference's 16x upscale (448^2 images
    with radii of tens of pixels)."""
    img = np.asarray(img, bool)
    if radius <= 0:
        return img.copy()
    return ndi.distance_transform_edt(~img) <= radius


def disk_erosion(img: np.ndarray, radius: float) -> np.ndarray:
    """Binary erosion by a Euclidean disk: erosion(img, disk(r)) ==
    {p in img : EDT to background > r}."""
    img = np.asarray(img, bool)
    if radius <= 0:
        return img.copy()
    return ndi.distance_transform_edt(img) > radius


def _grey_dilation(img: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grey dilation with a *weighted* (anti-aliased) disk: the reference
    dilates a binary image with a fractional-valued disk obtained by
    pyramid-reducing a magnified disk (``morphomnist/perturb.py:182-207``);
    the effect is max over the footprint of img*weight."""
    if footprint.max() <= 0:
        return img.astype(float)
    # separate full-weight core and fractional rim for efficiency
    out = np.zeros_like(img, dtype=float)
    h, w = footprint.shape
    ci, cj = h // 2, w // 2
    imgf = img.astype(float)
    for di in range(h):
        for dj in range(w):
            wgt = footprint[di, dj]
            if wgt <= 0:
                continue
            shifted = np.roll(np.roll(imgf, di - ci, axis=0), dj - cj, axis=1)
            np.maximum(out, wgt * shifted, out)
    return out


class Thinning(Perturbation):
    """Erode by a fraction of the estimated stroke thickness."""

    def __init__(self, amount: float = 0.7):
        self.amount = amount

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        radius = int(self.amount * morph.scale * morph.mean_thickness / 2.0)
        return disk_erosion(morph.binary_image, radius)


class Thickening(Perturbation):
    """Dilate by a fraction of the estimated stroke thickness."""

    def __init__(self, amount: float = 1.0):
        self.amount = amount

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        radius = int(self.amount * morph.scale * morph.mean_thickness / 2.0)
        return disk_dilation(morph.binary_image, radius)


class Deformation(Perturbation):
    """Coordinate-warp perturbations (output coords -> input coords)."""

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        h, w = morph.binary_image.shape
        yy, xx = np.mgrid[0:h, 0:w]
        xy = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(float)  # (N, 2) as (x, y)
        src = self.warp(xy, morph)
        coords = np.stack([src[:, 1].reshape(h, w), src[:, 0].reshape(h, w)])
        warped = ndi.map_coordinates(
            morph.binary_image.astype(float), coords, order=0, mode="constant"
        )
        return warped

    def warp(self, xy: np.ndarray, morph: ImageMorphology) -> np.ndarray:
        raise NotImplementedError


class Swelling(Deformation):
    """Local radial power-transform swelling at a random skeleton point."""

    def __init__(self, strength: float = 3, radius: float = 7):
        self.strength = strength
        self.radius = radius
        self.loc_sampler = skeleton.LocationSampler()

    def warp(self, xy: np.ndarray, morph: ImageMorphology) -> np.ndarray:
        centre = self.loc_sampler.sample(morph)[::-1]
        radius = (self.radius * np.sqrt(morph.mean_thickness) / 2.0) * morph.scale
        offset = xy - centre
        distance = np.hypot(offset[:, 0], offset[:, 1])
        with np.errstate(divide="ignore", invalid="ignore"):
            weight = (distance / radius) ** (self.strength - 1)
        weight[distance > radius] = 1.0
        weight = np.nan_to_num(weight, nan=0.0)
        return centre + weight[:, None] * offset


class Fracture(Perturbation):
    """Erase thin line segments perpendicular to the stroke at random
    skeleton locations (avoiding tips and forks)."""

    _ANGLE_WINDOW = 2
    _FRAC_EXTENSION = 0.5

    def __init__(self, thickness: float = 1.5, prune: float = 2, num_frac: int = 3):
        self.thickness = thickness
        self.prune = prune
        self.num_frac = num_frac
        self.loc_sampler = skeleton.LocationSampler(prune, prune)

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        up_thickness = self.thickness * morph.scale
        r = int(np.ceil((up_thickness - 1) / 2))
        brush = ~disk(r).astype(bool)
        frac_img = np.pad(morph.binary_image, pad_width=r, mode="constant")
        try:
            centres = self.loc_sampler.sample(morph, self.num_frac)
        except ValueError:  # overpruned skeleton: retry without pruning
            centres = skeleton.LocationSampler().sample(morph, self.num_frac)
        for centre in centres:
            p0, p1 = self._endpoints(morph, centre)
            self._draw_line(frac_img, p0, p1, brush)
        return frac_img[r:-r, r:-r]

    def _endpoints(self, morph, centre):
        angle = skeleton.get_angle(
            morph.skeleton, *centre, self._ANGLE_WINDOW * morph.scale
        )
        length = morph.distance_map[centre[0], centre[1]] + self._FRAC_EXTENSION * morph.scale
        angle += np.pi / 2.0  # perpendicular to the stroke
        normal = length * np.array([np.sin(angle), np.cos(angle)])
        return (centre + normal).astype(int), (centre - normal).astype(int)

    @staticmethod
    def _line_pixels(p0, p1):
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
        ii = np.linspace(p0[0], p1[0], n).round().astype(int)
        jj = np.linspace(p0[1], p1[1], n).round().astype(int)
        return ii, jj

    @classmethod
    def _draw_line(cls, img, p0, p1, brush):
        h, w = brush.shape
        h0, w0 = h // 2, w // 2
        for i, j in zip(*cls._line_pixels(p0, p1)):
            if 0 <= i - h0 and i - h0 + h <= img.shape[0] and 0 <= j - w0 and j - w0 + w <= img.shape[1]:
                img[i - h0 : i - h0 + h, j - w0 : j - w0 + w] &= brush


def _soft_disk(radius: int, scale: int = 16) -> np.ndarray:
    """Anti-aliased disk: magnified disk pyramid-reduced back down — the
    reference's disk cache construction (``morphomnist/perturb.py:182-187``)."""
    if radius <= 0:
        return np.ones((1, 1))
    mag = disk(scale * radius, dtype=np.float64)
    small = pyramid_reduce(mag, downscale=scale, order=1)
    return np.clip(small, 0.0, 1.0)


class SetThickness(Perturbation):
    """Dilate/erode the binary digit to a target mean thickness.

    The footprint is the nonzero support of the reference's anti-aliased
    disk cache (``morphomnist/perturb.py:182-187``), which slightly
    exceeds the exact Euclidean radius — using a bare EDT radius test
    here would make synthesized-dataset thicknesses differ sub-pixel
    from reference-generated data."""

    _footprint_cache: dict = {}

    def __init__(self, target_thickness: float):
        self.target_thickness = target_thickness

    @classmethod
    def _footprint(cls, radius: int) -> np.ndarray:
        if radius not in cls._footprint_cache:
            cls._footprint_cache[radius] = _soft_disk(radius) > 0
        return cls._footprint_cache[radius]

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        delta = self.target_thickness - morph.mean_thickness
        radius = int(morph.scale * abs(delta) / 2.0)
        img = morph.binary_image
        fp = self._footprint(radius)
        return _binary_dilation(img, fp) if delta >= 0 else _binary_erosion(img, fp)


class SetIntensity(Perturbation):
    """Rescale pixel values so the median bright intensity hits the target
    (brightness semantics of ``create_train_dataset.py:82-85``)."""

    def __init__(self, target_intensity: float):
        self.target_intensity = target_intensity

    def __call__(self, morph: ImageMorphology):
        img = morph.hires_image
        img_min, img_max = img.min(), img.max()
        current = np.median(img[img >= img_min + (img_max - img_min) * 0.5])
        mult = self.target_intensity / current
        return np.clip(morph.downscale(img) * mult, 0, 255)


class LinearDeformation(Deformation):
    """Centroid-anchored linear warp."""

    def _get_matrix(self, moments: ImageMoments, morph: ImageMorphology) -> np.ndarray:
        raise NotImplementedError

    def warp(self, xy: np.ndarray, morph: ImageMorphology) -> np.ndarray:
        moments = ImageMoments(morph.binary_image.astype(float))
        centroid = np.array(moments.centroid)
        matrix = self._get_matrix(moments, morph)
        return (xy - centroid) @ matrix.T + centroid


class SetSlant(LinearDeformation):
    """Shear to a target slant angle (radians)."""

    def __init__(self, target_slant_rad: float):
        self.target_shear = -np.tan(target_slant_rad)

    def _get_matrix(self, moments: ImageMoments, morph: ImageMorphology) -> np.ndarray:
        delta = self.target_shear - moments.horizontal_shear
        return np.array([[1.0, -delta], [0.0, 1.0]])


def _measure_width(morph: ImageMorphology, frac=0.02, moments: ImageMoments = None):
    top_left, top_right = bounding_parallelogram(
        morph.hires_image, frac=frac, moments=moments
    )[:2]
    return (top_right[0] - top_left[0]) / morph.scale


class SetWidth(LinearDeformation):
    """Horizontally rescale to a target width, preserving shear."""

    _tolerance = 1.0

    def __init__(self, target_width: float, validate: bool = False):
        self.target_width = target_width
        self._validate = validate

    def _get_matrix(self, moments: ImageMoments, morph: ImageMorphology) -> np.ndarray:
        source_width = _measure_width(morph, moments=moments)
        factor = source_width / self.target_width
        shear = moments.horizontal_shear
        return np.array([[factor, shear * (1.0 - factor)], [0.0, 1.0]])

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        pert = super().__call__(morph)
        if self._validate:
            pert_morph = ImageMorphology(
                morph.downscale(pert), threshold=morph.threshold, scale=morph.scale,
                engine=morph.engine,
            )
            width = _measure_width(pert_morph)
            if abs(width - self.target_width) > self._tolerance:
                pert = self(pert_morph)
        return pert
