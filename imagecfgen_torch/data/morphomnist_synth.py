"""Morpho-MNIST dataset synthesis with the ground-truth SCM (port of
``imagecfgen_tpu/data/morphomnist_synth.py``).

Reference semantics (``create_train_dataset.py:20-104``):

- ground-truth SCM:  t = Gamma(10, rate 5) + 0.5;
  i = 191 * sigmoid(0.5*e_i + 2*t - 5) + 64, e_i ~ N(0,1);
  s = pi * N(0, 0.1);
- per image: SetThickness(t) at 16x upscale, re-morph, SetSlant(s),
  downscale, then rescale pixel values so the median bright intensity
  equals i;
- emits ``mnist-x-train.npy`` (N, 28, 28) float32 and ``mnist-a-train.npy``
  (N, 13) = [one-hot digit(10), t, i, s].

Synthesis is host work. ``workers > 1`` spreads the glyphs over a process
pool made by the ``spawn`` start method: a forked child of a process that
has touched CUDA would inherit its context. The skeletons' engine
(``"native"`` or ``"python"``) is the caller's choice.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from ..morphomnist._skeletonize import check_engine
from ..morphomnist.morpho import ImageMorphology
from ..morphomnist.perturb import SetSlant, SetThickness


@dataclasses.dataclass
class GroundTruthSCM:
    """The closed-form data-generating SCM for Morpho-MNIST attributes."""

    rng: np.random.Generator

    def sample_thickness(self, n: int, noise: Optional[np.ndarray] = None) -> np.ndarray:
        et = self.rng.gamma(10.0, 1.0 / 5.0, (n, 1)) if noise is None else noise
        return (et + 0.5).astype(np.float32)

    def sample_slant(self, n: int, noise: Optional[np.ndarray] = None) -> np.ndarray:
        es = self.rng.normal(0.0, 0.1, (n, 1)) if noise is None else noise
        return (np.pi * es).astype(np.float32)

    def sample_intensity(self, t: np.ndarray, noise: Optional[np.ndarray] = None) -> np.ndarray:
        ei = self.rng.normal(0.0, 1.0, t.shape) if noise is None else noise
        return (191.0 / (1.0 + np.exp(-(0.5 * ei + 2.0 * t - 5.0))) + 64.0).astype(
            np.float32
        )

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        t = self.sample_thickness(n)
        i = self.sample_intensity(t)
        s = self.sample_slant(n)
        return t, i, s


def perturb_image(
    image: np.ndarray, thickness: float, intensity: float, slant: float, scale: int = 16,
    engine: str = "native",
) -> np.ndarray:
    """Apply SetThickness -> SetSlant -> intensity rescale to one digit."""
    morph = ImageMorphology(image.reshape(28, 28), scale=scale, engine=engine)
    thick = np.float32(SetThickness(thickness)(morph))
    hires = np.float32(SetSlant(slant)(ImageMorphology(thick, engine=engine)))
    img = morph.downscale(hires)

    img_min, img_max = img.min(), img.max()
    if img_max > img_min:
        current = np.median(img[img >= img_min + (img_max - img_min) * 0.5])
        img = np.clip(img * (intensity / max(current, 1e-6)), 0, 255)
    return img.astype(np.float32)


def _perturb_unpack(args):
    return perturb_image(*args)


def _collect(gen, n: int, progress: bool) -> np.ndarray:
    """The glyphs of ``gen`` stacked; with ``progress``, a printed count at
    every tenth of the way."""
    out, step = [], max(1, -(-n // 10))
    for k, img in enumerate(gen, 1):
        out.append(img)
        if progress and (k % step == 0 or k == n):
            print(f"synthesized {k}/{n} glyphs", file=sys.stderr, flush=True)
    return np.stack(out, axis=0)


def perturb_batch(images: np.ndarray, thickness, intensity, slant, scale: int = 16,
                  workers: int = 1, progress: bool = False, engine: str = "native") -> np.ndarray:
    """``perturb_image`` on each row, its targets taken as Python floats:
    (N, 28, 28) float32. ``workers > 1``: a spawned process pool (the
    glyphs are the same either way)."""
    check_engine(engine)
    n = len(images)
    args = [(images[k], float(thickness[k]), float(intensity[k]), float(slant[k]), scale, engine)
            for k in range(n)]
    if workers > 1 and n > 1:
        if engine == "native":  # built once here, not raced for by the workers
            from ..morphomnist.engine import _native_lib

            _native_lib()
        chunk = max(1, min(64, -(-n // (4 * workers))))
        with multiprocessing.get_context("spawn").Pool(min(workers, n)) as pool:
            return _collect(pool.imap(_perturb_unpack, args, chunksize=chunk), n, progress)
    return _collect(map(_perturb_unpack, args), n, progress)


def synthesize_dataset(
    images: np.ndarray,
    labels: np.ndarray,
    seed: int = 0,
    scale: int = 16,
    workers: int = 1,
    attrs: Optional[Dict[str, np.ndarray]] = None,
    progress: bool = False,
    engine: str = "native",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (N,28,28) float32, a (N,13) float32) in the reference's
    column layout. ``attrs`` may supply pre-drawn thickness/intensity/slant
    (the test-set script reuses DeepSCM-provided values,
    ``create_test_dataset.py:94-109``). ``workers``: see
    :func:`perturb_batch`."""
    n = len(images)
    scm = GroundTruthSCM(np.random.default_rng(seed))
    if attrs is None:
        t, i, s = scm.sample(n)
    else:
        t = np.asarray(attrs["thickness"], np.float32).reshape(n, 1)
        i = np.asarray(attrs["intensity"], np.float32).reshape(n, 1)
        s = np.asarray(attrs["slant"], np.float32).reshape(n, 1)

    x = perturb_batch(images, t[:, 0], i[:, 0], s[:, 0], scale, workers, progress, engine)
    a = np.zeros((n, 13), dtype=np.float32)
    a[np.arange(n), np.asarray(labels, int)] = 1.0
    a[:, 10] = t[:, 0]
    a[:, 11] = i[:, 0]
    a[:, 12] = s[:, 0]
    return x, a
