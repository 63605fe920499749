"""What the port's AudioMNIST CLIs share: the dataset, the training arrays and
the artifacts (port of ``imagecfgen_tpu/cli/audio_common.py``).

Artifacts keep the JAX package's names:

- ``audio-mnist-bigan.tar``: the GAN trainer's state, the spectrogram
  statistics and the vocabularies (in the meta);
- ``audio-mnist-attribute-scm.tar``: the attribute SCM;
- ``audio-mnist-{attr}-clf.tar``: an attribute classifier and the
  spectrogram statistics it was trained on;
- ``audio-mnist-vae.tar``: the VAE trainer's state and the statistics;
- ``audio-gan-{gan,wgan}.tar``: the unconditional GAN trainer's state and
  the statistics.

The port writes its own files (magic ``ICFP``) and reads both kinds, told
apart by their magic: a model directory the JAX CLIs wrote (magic ``ICFT``)
is carried across by ``core.convert``.

Without the AudioMNIST zip the CLIs warn and run on the synthetic stand-in
(``data/audio_mnist.py``), as the JAX package's do: that is data, not a
device, and nothing else falls back.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import checkpoint_format, load_checkpoint, load_train_state, save_train_state
from ..core.convert import audio_scm_from_jax_state_dict, gan_state_from_jax, uncond_gan_state_from_jax
from ..data.audio_mnist import AudioMNISTData
from ..device import DeviceLike
from ..models import bigan as bigan_configs
from ..models import classifier as classifier_configs
from ..models.bigan import BiGAN
from ..models.classifier import CNNClassifier
from ..models.vae import ConditionalVAE, audio_mnist_vae_config
from ..ops.spectral import SpectStats
from ..scm.audio_mnist import CARDINALITIES, AudioMNISTAttributeSCM
from .common import (
    bigan_from_state,
    load_spect_classifier,
    load_spect_trainer,
    load_spect_vae,
    save_spect_classifier,
    save_spect_trainer,
    vae_state_from_jax,
)


def load_audio_dataset(zip_path: Optional[str], synthetic_runs: int = 4) -> AudioMNISTData:
    """The zip when it exists, else the synthetic stand-in (with a warning
    when a path was given)."""
    if zip_path and os.path.exists(zip_path):
        return AudioMNISTData(path_to_zip=zip_path)
    if zip_path:
        print(f"warning: {zip_path} not found; using the synthetic AudioMNIST stand-in")
    return AudioMNISTData(path_to_zip=None, synthetic_runs=synthetic_runs)


def prepare_training_arrays(data: AudioMNISTData, excluded_runs=None, device: DeviceLike = None
                            ) -> Tuple[torch.Tensor, Dict[str, np.ndarray], SpectStats]:
    """(images ``(N, 128, 128, 1)`` in [-1, 1] on ``device``, the attributes'
    one-hots, the statistics) of the training rows; by default the
    dataset's validation runs are left out."""
    if excluded_runs is None:
        excluded_runs = data.training_excluded_runs
    spects, attrs, _ = data.all_spectrograms(excluded_runs=excluded_runs, device=device)
    stats = SpectStats.compute(spects)
    return stats.spect_to_img(spects)[..., None], attrs, stats


def validation_images(data: AudioMNISTData, stats: SpectStats, device: DeviceLike = None):
    """(images ``(N, 128, 128, 1)`` on ``device``, one-hots, row indices) of
    the validation runs, normalised with ``stats``."""
    spects, attrs, idx = data.all_spectrograms(excluded_runs=data.validation_excluded_runs,
                                               device=device)
    return stats.to(spects.device).spect_to_img(spects)[..., None], attrs, idx


def _vocab_meta(data: AudioMNISTData) -> Dict:
    out = {k: list(map(str, v.categories)) for k, v in data.vocabs.items()}
    out["age_edges"] = [float(e) for e in data.age_binner.edges]
    return out


# ------------------------------------------------------------------ BiGAN


def save_audio_bigan(path: str, state: Mapping, stats: SpectStats, data: AudioMNISTData,
                     meta: Optional[Dict] = None) -> None:
    """A ``GANTrainer.state_dict()``, the statistics and the vocabularies."""
    save_spect_trainer(path, state, stats, "bigan-audio-mnist", {"vocabs": _vocab_meta(data), **(meta or {})})


def load_audio_bigan(path: str, device: DeviceLike = None) -> Tuple[Dict, SpectStats, Dict]:
    """``(trainer state, statistics on device, meta)`` of either kind of
    file, the state in ``GANTrainer.state_dict()``'s form (from a JAX file:
    no generator). A file without statistics raises
    ``cli.common.MissingStatsError``: every caller maps spectrograms with
    them."""
    return load_spect_trainer(path, lambda tree, meta: gan_state_from_jax(tree), device, need_stats=True)


def load_audio_bigan_model(path: str, device: DeviceLike = None) -> Tuple[BiGAN, SpectStats, Dict]:
    """``(the BiGAN in eval mode, statistics, meta)`` of either kind of
    ``audio-mnist-bigan.tar``, at the ``d`` its meta names."""
    state, stats, meta = load_audio_bigan(path, device)
    cfg = bigan_configs.audio_mnist_bigan_config(d=meta.get("d", 64))
    return bigan_from_state(state, cfg, stats.mean.device).eval(), stats, meta


# ------------------------------------------------------------------ SCM


def save_audio_scm(path: str, scm: AudioMNISTAttributeSCM) -> None:
    save_train_state(path, scm.state_dict(), meta={"kind": "attribute-scm-audio-mnist"})


def load_audio_scm(path: str, device: DeviceLike = None) -> AudioMNISTAttributeSCM:
    if checkpoint_format(path) == "torch":
        return AudioMNISTAttributeSCM.from_state_dict(load_train_state(path, device)[0], device)
    return audio_scm_from_jax_state_dict(load_checkpoint(path)[0], device)


# ------------------------------------------------------------ classifier


def save_audio_classifier(path: str, state: Mapping, stats: SpectStats, meta: Dict) -> None:
    """A ``SupervisedTrainer.state_dict()`` and the statistics it trained
    on; ``meta`` names the attribute, the classes and the width."""
    save_spect_classifier(path, state, stats, {"kind": "audio-mnist-clf", **meta})


def load_audio_classifier(path: str, n_classes: int, device: DeviceLike = None
                          ) -> Tuple[CNNClassifier, SpectStats, Dict]:
    """``(the classifier in eval mode, its statistics, meta)`` of either
    kind of file, at the width its meta names."""
    return load_spect_classifier(
        path, lambda meta: classifier_configs.audio_mnist_classifier_config(n_classes, width=meta.get("width", 1.0)),
        device)


# ------------------------------------------------------------------ VAE


def save_audio_vae(path: str, state: Mapping, stats: SpectStats, meta: Optional[Dict] = None) -> None:
    """A ``VAETrainer.state_dict()`` and the statistics."""
    save_spect_trainer(path, state, stats, "vae-audio-mnist", meta)


def load_audio_vae_state(path: str, device: DeviceLike = None
                         ) -> Tuple[Optional[Dict], Optional[SpectStats], Dict]:
    """``(trainer state, statistics, meta)`` of either kind of
    ``audio-mnist-vae.tar``, the state in ``VAETrainer.state_dict()``'s form
    (from a JAX file: no generator). A JAX file written before its trainer
    saved the optimiser and the noise key (``carries_rng`` unset) has no
    state to resume (None), and one without statistics gives None for them."""
    return load_spect_trainer(path, vae_state_from_jax, device)


def load_audio_vae_model(path: str, device: DeviceLike = None
                         ) -> Tuple[ConditionalVAE, Optional[SpectStats], Dict]:
    """``(the VAE in eval mode, statistics or None, meta)`` of either kind
    of ``audio-mnist-vae.tar``, at the ``d`` its meta names."""
    return load_spect_vae(path, lambda meta: audio_mnist_vae_config(d=meta.get("d", 64)), device)


def load_audio_vae(path: str, device: DeviceLike = None) -> ConditionalVAE:
    """The VAE alone of :func:`load_audio_vae_model`."""
    return load_audio_vae_model(path, device)[0]


# ------------------------------------------------------- unconditional GAN


def save_audio_gan(path: str, state: Mapping, stats: SpectStats, loss_mode: str,
                   meta: Optional[Dict] = None) -> None:
    """An ``UncondGANTrainer.state_dict()`` and the statistics."""
    save_spect_trainer(path, state, stats, f"uncond-gan-{loss_mode}", meta)


def load_audio_gan(path: str, device: DeviceLike = None) -> Tuple[Dict, SpectStats, Dict]:
    """``(trainer state, statistics, meta)`` of either kind of
    ``audio-gan-{mode}.tar``, the state in ``UncondGANTrainer.state_dict()``'s
    form (from a JAX file: no generator)."""
    return load_spect_trainer(path, lambda tree, meta: uncond_gan_state_from_jax(tree), device)


def one_hots(codes: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Integer codes ``(B,)`` or ``(B, 1)`` -> the models' float one-hots."""
    return {k: torch.nn.functional.one_hot(codes[k].reshape(-1).long(), n).float()
            for k, n in CARDINALITIES.items()}
