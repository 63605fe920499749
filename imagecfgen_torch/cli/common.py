"""What the port's CLIs share: data loading, artifacts and image grids (port
of ``imagecfgen_tpu/cli/common.py``).

Artifacts keep the JAX package's names (``mnist-bigan.tar``,
``mnist-attribute-scm.tar``, ``mnist_clf.tar``, ``ae-{cls}.tar``,
``mnist-vae.tar``). The port
writes its own files (magic ``ICFP``, ``core.checkpoint.save_train_state``)
and reads both kinds, told apart by their magic, never by their name: a
model directory that the JAX CLIs wrote (magic ``ICFT``) is carried across
by ``core.convert`` and can be scored, or resumed, here.

Image grids and scatter panels are 8-bit grayscale PNGs written with
``zlib`` and ``struct`` (the machine with the card has no matplotlib); the
figure CLIs' panels (curves with one emphasised, bars, images) are RGB
rasters side by side in one 8-bit RGB PNG. Axes, ticks and legends are not
drawn: the CLIs print what a reader needs beside the file.
"""
from __future__ import annotations

import os
import struct
import sys
import warnings
import zlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.attributes import MNIST_SPEC, AttributeScaler
from ..core.checkpoint import checkpoint_format, load_checkpoint, load_train_state, save_train_state
from ..core.convert import (
    autoencoder_params_from_jax,
    classifier_params_from_jax,
    gan_state_from_jax,
    scm_from_jax_state_dict,
    vae_params_from_jax,
    vae_trainer_state_from_jax,
)
from ..data.mnist import load_mnist_arrays
from ..device import DeviceLike, resolve_device
from ..models.bigan import BiGAN, BiGANConfig
from ..models.classifier import AutoEncoderConfig, ClassifierConfig, CNNClassifier, ConvAutoEncoder
from ..models.vae import ConditionalVAE
from ..ops.spectral import SpectStats
from ..parallel.mesh import DataMesh, init_from_env
from ..scm.mnist import MNISTAttributeSCM
from ..utils import profiling

# ------------------------------------------------------------------ data


def load_mnist_training_data(data_dir: str, split: str = "train"):
    """Returns (x_scaled (N,28,28,1) in [-1,1], attrs raw dict, scaler).

    Images scale [0,255] -> [-1,1]; the scaler carries the split's min/max
    of the continuous attributes.
    """
    x, attrs = load_mnist_arrays(data_dir, split)
    x = (2.0 * x.reshape((-1, 28, 28, 1)) / 255.0 - 1.0).astype(np.float32)
    scaler = AttributeScaler.fit(MNIST_SPEC, attrs)
    return x, attrs, scaler


def scale_attrs(scaler: AttributeScaler, attrs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``scaler.scale`` on a dict of numpy arrays."""
    scaled = scaler.scale({k: torch.from_numpy(np.asarray(v)) for k, v in attrs.items()})
    return {k: v.numpy() for k, v in scaled.items()}


def artifact_path(override, model_dir, default_name):
    """Resolve a model artifact: a per-file flag (e.g. ``--image-model``)
    overrides the ``--model-dir`` layout when given."""
    return override if override else os.path.join(model_dir or ".", default_name)


def has_test_split(data_dir: str) -> bool:
    return os.path.exists(os.path.join(data_dir, "mnist-x-test.npy"))


# ------------------------------------------------------------------ BiGAN


def _scaler_tensors(scaler: AttributeScaler) -> Dict:
    """The scaler's state as tensors: the port's files are read back with
    ``weights_only=True``."""
    return {part: {k: torch.as_tensor(v) for k, v in stats.items()}
            for part, stats in scaler.state_dict().items()}


def _scaler_arrays(stats: Mapping) -> Dict:
    return {part: {k: v.cpu().numpy() for k, v in d.items()} for part, d in stats.items()}


def save_bigan(path: str, state: Mapping, scaler: AttributeScaler, meta: Optional[Dict] = None):
    """A ``GANTrainer.state_dict()`` and the scaler."""
    save_train_state(path, {"trainer": dict(state), "scaler": _scaler_tensors(scaler)},
                     meta={"kind": "bigan", "carries_rng": state.get("rng") is not None, **(meta or {})})


def load_bigan(path: str, device: DeviceLike = None) -> Tuple[Dict, AttributeScaler, Dict]:
    """``(trainer state, scaler, meta)`` of either kind of file; the state
    in ``GANTrainer.state_dict()``'s form (from a JAX file: no generator)."""
    if checkpoint_format(path) == "torch":
        payload, meta = load_train_state(path, device)
        state = payload["trainer"]
        stats = _scaler_arrays(payload["scaler"])
    else:
        tree, meta = load_checkpoint(path)
        state, stats = gan_state_from_jax(tree), tree["scaler"]
    if meta.get("scaler_valid") is False:
        warnings.warn(
            f"{path} was converted without training data: its attribute "
            "scaler is an identity placeholder and downstream counterfactuals "
            "will consume unscaled attributes. Re-convert with --data-dir.",
            stacklevel=2,
        )
    return state, AttributeScaler.from_state_dict(MNIST_SPEC, stats), meta


def bigan_from_state(state: Mapping, cfg: BiGANConfig, device: DeviceLike = None) -> BiGAN:
    """A ``BiGAN`` for ``cfg`` holding the E, G and D of a trainer state (E
    and G alone for a state without D: the ESRF fine-tune's file)."""
    model = BiGAN(cfg, device)
    model.encoder.load_state_dict(state["E"])
    model.generator.load_state_dict(state["G"])
    if "D" in state:
        model.discriminator.load_state_dict(state["D"])
    return model


# ---------------------------------------------------------------- training


def data_parallel(device: DeviceLike) -> Tuple[DataMesh, torch.device]:
    """``(mesh, device)`` of a training CLI's process
    (``parallel.init_from_env``): under ``torchrun``, this rank's place in the
    launcher's group and its card (NCCL) or the CPU (gloo); a plain run is one
    process with no group. Every rank but 0 prints nothing (its standard
    output goes to ``os.devnull``), and the CLIs write their files on rank 0
    alone (``mesh.is_main``); every rank reads (``--resume``)."""
    mesh, device = init_from_env(device)
    if not mesh.is_main:
        sys.stdout = open(os.devnull, "w")
    return mesh, device


def warm_start(trainer, state: Mapping, path: str) -> None:
    """E, G and D of the trainer state ``state`` (read from ``path``) into
    ``trainer``'s model."""
    m = trainer.model
    for part, module in (("E", m.encoder), ("G", m.generator), ("D", m.discriminator)):
        module.load_state_dict(state[part])
    print(f"warm-started from {path}")


def fit_gan_epochs(trainer, train: Mapping, out: str, args, load: Callable[[str], Tuple[Mapping, object, Dict]],
                   save: Callable[[str, Dict, int], None]) -> None:
    """The BiGAN training CLIs' loop: continue the state in ``out`` when
    ``args.resume`` finds one there (``load(path)`` gives its trainer state,
    statistics and meta), then train to epoch ``args.steps`` on ``train`` (from
    ``trainer.upload_dataset``), calling ``save(path, state, epoch)`` every
    ``args.checkpoint_every`` epochs and at the last, on the mesh's rank 0."""
    start_epoch = 0
    if args.resume and os.path.exists(out):
        state, _, meta = load(out)
        trainer.load_state_dict(state)
        del state
        start_epoch = int(meta.get("epoch", 0))
        print(f"resumed from {out} at epoch {start_epoch} (step {trainer.step})")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    nb = max(len(train["image"]) // args.batch_size, 1)
    for epoch in range(start_epoch, args.steps):
        metrics, dt = profiling.timed(trainer.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: D(G(z))={metrics['D_score']:.4f} "
              f"D(E(x))={metrics['EG_score']:.4f} ({nb / dt:.1f} steps/s, step {trainer.step})")
        due = (epoch + 1) % args.checkpoint_every == 0 or (epoch + 1) == args.steps
        if due and trainer.mesh.is_main:
            save(out, trainer.state_dict(), epoch + 1)
    print(f"saved {out}")


# ------------------------------------------------------------------ VAE


def save_vae(path: str, state: Mapping, scaler: AttributeScaler, meta: Optional[Dict] = None):
    """A ``VAETrainer.state_dict()`` and the scaler."""
    save_train_state(path, {"trainer": dict(state), "scaler": _scaler_tensors(scaler)},
                     meta={"kind": "vae-mnist", **(meta or {})})


def load_vae(path: str, cfg: BiGANConfig, device: DeviceLike = None
             ) -> Tuple[ConditionalVAE, AttributeScaler, Dict]:
    """``(the VAE for cfg in eval mode, scaler, meta)`` of either kind of
    file: the port's (:func:`save_vae`) or the JAX package's (its
    ``{"params": {"encoder", "decoder"}, "scaler"}`` tree)."""
    if checkpoint_format(path) == "torch":
        payload, meta = load_train_state(path, device)
        model = ConditionalVAE(cfg, device)
        model.load_state_dict(payload["trainer"]["module"])
        stats = _scaler_arrays(payload["scaler"])
    else:
        tree, meta = load_checkpoint(path)
        model, stats = vae_params_from_jax(tree["params"], cfg, device), tree["scaler"]
    return model.eval(), AttributeScaler.from_state_dict(MNIST_SPEC, stats), meta


# ------------------------------------------------------------------ SCM


def save_attribute_scm(path: str, scm: MNISTAttributeSCM):
    save_train_state(path, scm.state_dict(), meta={"kind": "attribute-scm-mnist"})


def load_attribute_scm(path: str, device: DeviceLike = None) -> MNISTAttributeSCM:
    if checkpoint_format(path) == "torch":
        return MNISTAttributeSCM.from_state_dict(load_train_state(path, device)[0], device)
    tree = dict(load_checkpoint(path)[0])
    tree["bounds"] = {k: tuple(float(b) for b in v) for k, v in tree["bounds"].items()}
    return scm_from_jax_state_dict(tree, device)


# ---------------------------------------------- classifier, autoencoder

Supervised = Union[CNNClassifier, ConvAutoEncoder]


def save_classifier(path: str, state: Mapping, meta: Optional[Dict] = None):
    """A ``SupervisedTrainer.state_dict()`` (a classifier's or an
    autoencoder's)."""
    save_train_state(path, dict(state), meta=meta)


def load_classifier(path: str, cfg: Union[ClassifierConfig, AutoEncoderConfig],
                    device: DeviceLike = None) -> Supervised:
    """The classifier (``ClassifierConfig``) or autoencoder
    (``AutoEncoderConfig``) of either kind of file, in eval mode."""
    if checkpoint_format(path) == "jax":
        params = load_checkpoint(path)[0]["params"]
        if isinstance(cfg, AutoEncoderConfig):
            return autoencoder_params_from_jax(params, cfg, device).eval()
        return classifier_params_from_jax(params, cfg, device).eval()
    model = (ConvAutoEncoder if isinstance(cfg, AutoEncoderConfig) else CNNClassifier)(cfg, device)
    model.load_state_dict(load_train_state(path, device)[0]["module"])
    return model.eval()


# ------------------------------------------- spectrogram models' artifacts
#
# The audio and marine CLIs' files: a trainer's state (or a classifier's) and
# the spectrogram statistics it trained on; each CLI module names its meta
# ``kind``, its config and how a JAX file's tree is carried across.


def stats_tensors(stats: SpectStats) -> Dict[str, torch.Tensor]:
    return {"spect_mean": stats.mean.detach().cpu(), "spect_std": stats.std.detach().cpu()}


class MissingStatsError(KeyError):
    """A model file holds no spectrogram statistics, and its loader's callers
    need them (the JAX loaders' ``KeyError`` at load)."""


def stats_of(tree: Mapping, device: torch.device, required_by: Optional[str] = None) -> Optional[SpectStats]:
    """The statistics a file holds, on ``device``; None when it holds none,
    or :class:`MissingStatsError` naming ``required_by`` (the file's path)
    when that is given."""
    if "spect_mean" not in tree:
        if required_by is not None:
            raise MissingStatsError(f"{required_by} holds no spectrogram statistics (spect_mean, spect_std)")
        return None
    return SpectStats(torch.as_tensor(tree["spect_mean"]).to(device),
                      torch.as_tensor(tree["spect_std"]).to(device))


def save_spect_trainer(path: str, state: Mapping, stats: SpectStats, kind: str,
                       meta: Optional[Dict] = None) -> None:
    """A trainer's ``state_dict()`` (or a part of one) and the statistics,
    under the meta ``kind``."""
    save_train_state(path, {"trainer": dict(state), **stats_tensors(stats)},
                     meta={"kind": kind, "carries_rng": state.get("rng") is not None, **(meta or {})})


def load_spect_trainer(path: str, from_jax: Callable[[Mapping, Dict], Optional[Dict]],
                       device: DeviceLike = None, need_stats: bool = False
                       ) -> Tuple[Optional[Dict], Optional[SpectStats], Dict]:
    """``(trainer state, statistics or None, meta)`` of either kind of file;
    ``from_jax(tree, meta)`` carries a JAX file's tree across (None: it
    holds no state to resume). ``need_stats``: a file without statistics
    raises :class:`MissingStatsError`."""
    device = resolve_device(device)
    required_by = path if need_stats else None
    if checkpoint_format(path) == "torch":
        payload, meta = load_train_state(path, device)
        return payload["trainer"], stats_of(payload, device, required_by), meta
    tree, meta = load_checkpoint(path)
    stats = stats_of(tree, device, required_by)
    return from_jax(tree, meta), stats, meta


def vae_state_from_jax(tree: Mapping, meta: Dict) -> Optional[Dict]:
    """A JAX VAE file's ``VAETrainer.state_dict()`` (no generator); None for
    a file written before its trainer saved the optimiser and the noise key
    (``carries_rng`` unset): it holds no state to resume."""
    return vae_trainer_state_from_jax(tree) if meta.get("carries_rng") else None


def save_spect_classifier(path: str, state: Mapping, stats: SpectStats, meta: Dict) -> None:
    """A ``SupervisedTrainer.state_dict()`` and the statistics it trained
    on; ``meta`` holds the ``kind`` and what the config needs."""
    save_train_state(path, {**dict(state), **stats_tensors(stats)}, meta=meta)


def load_spect_classifier(path: str, config_of: Callable[[Dict], ClassifierConfig], device: DeviceLike = None
                          ) -> Tuple[CNNClassifier, Optional[SpectStats], Dict]:
    """``(the classifier in eval mode, its statistics or None, meta)`` of
    either kind of file, at ``config_of(meta)``."""
    device = resolve_device(device)
    if checkpoint_format(path) == "torch":
        payload, meta = load_train_state(path, device)
        model = CNNClassifier(config_of(meta), device)
        model.load_state_dict(payload["module"])
        return model.eval(), stats_of(payload, device), meta
    tree, meta = load_checkpoint(path)
    return classifier_params_from_jax(tree["params"], config_of(meta), device).eval(), stats_of(tree, device), meta


def load_spect_vae(path: str, config_of: Callable[[Dict], BiGANConfig], device: DeviceLike = None
                   ) -> Tuple[ConditionalVAE, Optional[SpectStats], Dict]:
    """``(the VAE in eval mode, its statistics or None, meta)`` of either
    kind of file (a trainer's state, or the JAX package's ``params``), at
    ``config_of(meta)``."""
    device = resolve_device(device)
    if checkpoint_format(path) == "torch":
        payload, meta = load_train_state(path, device)
        model = ConditionalVAE(config_of(meta), device)
        model.load_state_dict(payload["trainer"]["module"])
        return model.eval(), stats_of(payload, device), meta
    tree, meta = load_checkpoint(path)
    return vae_params_from_jax(tree["params"], config_of(meta), device).eval(), stats_of(tree, device), meta


# ------------------------------------------------------------ explainers


def explainer_models(bigan_path: str, clf_path: str, device: DeviceLike = None):
    """``(encoder, generator, classifier)`` of the MNIST BiGAN in
    ``bigan_path`` and the MNIST classifier in ``clf_path`` (either
    package's files), in eval mode on ``device``: the encode, decode and
    classify functions the explainers take."""
    from ..models.bigan import mnist_bigan_config
    from ..models.classifier import mnist_classifier_config

    state, _, _ = load_bigan(bigan_path, device)
    model = bigan_from_state(state, mnist_bigan_config(), device).eval()
    return model.encoder, model.generator, load_classifier(clf_path, mnist_classifier_config(), device)


def rows_on(x: np.ndarray, attrs: Mapping[str, np.ndarray], rows: slice, device: DeviceLike = None):
    """``x[rows]`` and each attribute's ``[rows]`` as tensors on ``device``."""
    return (torch.from_numpy(np.ascontiguousarray(x[rows])).to(device),
            {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[rows])).to(device)
             for k, v in attrs.items()})


def write_csv(path: str, rows: Sequence[Mapping]) -> None:
    """Rows of dicts as CSV through the ``csv`` module, as
    ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes them: the
    columns in the order the first row holds them, NaN as an empty field."""
    import csv
    import math

    def field(v):
        v = v.item() if isinstance(v, np.generic) else v
        return "" if isinstance(v, float) and math.isnan(v) else v

    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(list(rows[0]))
        for r in rows:
            out.writerow([field(r[k]) for k in rows[0]])


# ------------------------------------------------------------------ PNG


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, pix: np.ndarray) -> None:
    """``pix``: uint8 ``(H, W)`` (grayscale) or ``(H, W, 3)`` (RGB), written
    with filter type 0 on every row."""
    h, w = pix.shape[:2]
    color = 2 if pix.ndim == 3 else 0
    raw = b"".join(b"\x00" + pix[r].tobytes() for r in range(h))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def save_grid_png(path: str, rows: Sequence, row_labels: Sequence[str], title: str = "",
                  vmin: float = -1, vmax: float = 1) -> np.ndarray:
    """Save a rows x n grid of equally sized images as an 8-bit grayscale
    PNG, row ``r`` holding ``rows[r]``'s images left to right, ``vmin`` ->
    0 and ``vmax`` -> 255; the title and the row labels go to stdout.
    Returns the grid's pixels."""
    grid = np.concatenate([np.concatenate([np.asarray(im, np.float32).squeeze() for im in imgs], axis=1)
                           for imgs in rows], axis=0)
    pix = np.clip(np.round((grid - vmin) / (vmax - vmin) * 255.0), 0, 255).astype(np.uint8)
    write_png(path, pix)
    print(f"{path}: {title}" if title else path)
    for r, label in enumerate(row_labels):
        print(f"  row {r + 1}: {label}")
    return pix


PANEL = (96, 160)  # (height, width) of a curve or bar panel
_FRAME, _CURVE, _EMPHASIS, _BAR = 0.3, (0.55, 0.55, 0.55), (1.0, 0.8, 0.2), (0.35, 0.6, 1.0)


def _framed(size: Tuple[int, int]) -> np.ndarray:
    """A black ``size`` RGB panel with its left and bottom edges drawn."""
    img = np.zeros((*size, 3), np.float32)
    img[:, 0], img[-1, :] = _FRAME, _FRAME
    return img


def _rows_of(v, lo: float, hi: float, h: int) -> np.ndarray:
    """Values -> pixel rows of a panel ``h`` high, ``hi`` at the top."""
    span = hi - lo if hi > lo else 1.0
    return np.clip(np.round((1.0 - (np.asarray(v, np.float64) - lo) / span) * (h - 3)) + 1, 1, h - 2).astype(int)


def curve_panel(ys, emphasis: Optional[int] = None, ylim: Optional[Tuple[float, float]] = None,
                size: Tuple[int, int] = PANEL) -> np.ndarray:
    """Curves ``ys`` ``(n_curves, n_points)`` over evenly spaced x as an RGB
    panel in [0, 1]: each a gray polyline, curve ``emphasis`` drawn last,
    two pixels thick and in colour; y over ``ylim`` (default: the finite
    values' range), up."""
    ys = np.atleast_2d(np.asarray(ys, np.float64))
    h, w = size
    finite = ys[np.isfinite(ys)]
    lo, hi = ylim if ylim is not None else ((finite.min(), finite.max()) if finite.size else (0.0, 1.0))
    img = _framed(size)
    cols = np.round(np.linspace(2, w - 2, ys.shape[1])).astype(int)
    order = [c for c in range(len(ys)) if c != emphasis] + ([emphasis] if emphasis is not None else [])
    for c in order:
        rows = _rows_of(np.nan_to_num(ys[c], nan=lo), lo, hi, h)
        for (c0, r0), (c1, r1) in zip(zip(cols, rows), zip(cols[1:], rows[1:])):
            n = max(abs(c1 - c0), abs(r1 - r0)) + 1
            rr = np.round(np.linspace(r0, r1, n)).astype(int)
            cc = np.round(np.linspace(c0, c1, n)).astype(int)
            color = _EMPHASIS if c == emphasis else _CURVE
            img[rr, cc] = color
            if c == emphasis:
                img[np.maximum(rr - 1, 0), cc] = color
    return img


def bar_panel(values, ylim: Tuple[float, float] = (0.0, 1.0), size: Tuple[int, int] = PANEL) -> np.ndarray:
    """One bar a value, evenly spaced, as an RGB panel in [0, 1], heights
    over ``ylim`` from its bottom."""
    values = np.asarray(values, np.float64).reshape(-1)
    h, w = size
    img = _framed(size)
    slot = (w - 2) / len(values)
    tops = _rows_of(values, ylim[0], ylim[1], h)
    for i, top in enumerate(tops):
        c0, c1 = int(2 + i * slot + slot * 0.15), int(2 + (i + 1) * slot - slot * 0.15)
        img[top:h - 1, c0:max(c1, c0 + 1)] = _BAR
    return img


def image_panel(img, vmin: float = -1.0, vmax: float = 1.0, height: int = PANEL[0]) -> np.ndarray:
    """A grayscale image (mapped from [vmin, vmax]) or an RGB one (in
    [0, 1]) as an RGB panel ``height`` high, enlarged by whole pixels."""
    img = np.asarray(img, np.float32).squeeze()
    if img.ndim == 2:
        img = np.repeat(((img - vmin) / (vmax - vmin))[..., None], 3, axis=2)
    k = max(1, height // img.shape[0])
    return np.clip(np.repeat(np.repeat(img, k, axis=0), k, axis=1), 0.0, 1.0)


def save_panels_png(path: str, panels: Sequence[np.ndarray], title: str = "", gap: int = 4) -> np.ndarray:
    """RGB panels in [0, 1] side by side, top-aligned on a black ground with
    ``gap`` pixels between them, as an 8-bit RGB PNG; the title goes to
    stdout. Returns the pixels."""
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + gap * (len(panels) - 1)
    out = np.zeros((h, w, 3), np.float32)
    at = 0
    for p in panels:
        out[:p.shape[0], at:at + p.shape[1]] = p
        at += p.shape[1] + gap
    pix = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
    write_png(path, pix)
    print(f"{path}: {title}" if title else path)
    return pix


def scatter_panel(x, y, size: int = 96) -> np.ndarray:
    """Points ``(x[k], y[k])`` and the line y = x as a ``size`` x ``size``
    image in [0, 1] (the line at 0.5, each point a 3x3 mark at 1), both axes
    over the finite values' common range, y up."""
    x, y = np.asarray(x, np.float64).reshape(-1), np.asarray(y, np.float64).reshape(-1)
    ok = np.isfinite(x) & np.isfinite(y)
    vals = np.concatenate([x[ok], y[ok]])
    lo, hi = (float(vals.min()), float(vals.max())) if vals.size else (0.0, 1.0)
    span = hi - lo if hi > lo else 1.0
    img = np.zeros((size, size), np.float32)
    diag = np.arange(size)
    img[size - 1 - diag, diag] = 0.5

    def pix(v):
        return np.clip(np.round((v - lo) / span * (size - 1)).astype(int), 0, size - 1)

    cols, rows = pix(x[ok]), size - 1 - pix(y[ok])
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            img[np.clip(rows + dr, 0, size - 1), np.clip(cols + dc, 0, size - 1)] = 1.0
    return img


def read_png(path: str) -> np.ndarray:
    """The pixels ``(H, W)`` (grayscale) or ``(H, W, 3)`` (RGB) uint8 of an
    8-bit PNG whose rows all use filter type 0 (what :func:`write_png`
    writes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    at, idat, head = 8, b"", None
    while at < len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        if struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        at += 12 + n
    if head is None or head[2] != 8 or head[3] not in (0, 2) or head[4] != 0:
        raise ValueError(f"{path}: not an 8-bit grayscale or RGB PNG ({head})")
    w, h = head[:2]
    ch = 3 if head[3] == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    pix = rows[:, 1:].copy()
    return pix.reshape(h, w, 3) if ch == 3 else pix
