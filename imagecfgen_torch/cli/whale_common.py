"""What the port's marine CLIs share: the whale-call and ESRF datasets, their
training arrays and the artifacts (port of ``imagecfgen_tpu/cli/
whale_common.py``, with the ESRF CLIs' shared parts beside it).

Artifacts keep the JAX package's names and meta kinds:

- ``whale-bigan.tar`` (``bigan-whale``), ``esrf-bigan.tar`` (``bigan-esrf``):
  the GAN trainer's state and the spectrogram statistics; the fine-tuned
  files (``whale-bigan-finetuned-{metric}.tar``,
  ``esrf-bigan-finetuned-{metric}.tar``) keep E and G, the ESRF one nothing
  else;
- ``whale-clf.tar`` (``whale-clf``): the NARW classifier and its statistics;
- ``whale-vae.tar`` (``vae-whale``): the VAE trainer's state and the
  statistics.

The port writes its own files (magic ``ICFP``) and reads both kinds, told
apart by their magic: a model directory that the JAX CLIs wrote (magic
``ICFT``) is carried across by ``core.convert`` and trains on, scores and
resumes here.

A real-data path that does not exist gives a warning and the synthetic
stand-in, as in the JAX package: that is data, not a device, and nothing
else falls back.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.convert import encoder_state_dict_from_jax, gan_state_from_jax, generator_state_dict_from_jax
from ..data.esrf import EsrfStation
from ..data.whalecalls import WhaleCallData
from ..device import DeviceLike, resolve_device
from ..models.classifier import CNNClassifier, narw_classifier_config
from ..models.vae import ConditionalVAE, whale_vae_config
from ..ops.spectral import SpectStats
from .common import (
    load_spect_classifier,
    load_spect_trainer,
    load_spect_vae,
    save_spect_classifier,
    save_spect_trainer,
    vae_state_from_jax,
)

# ------------------------------------------------------------------ data


def load_whale_dataset(nocall_dir: Optional[str], shotgun_dir: Optional[str], upcall_dir: Optional[str],
                       filter_length: Optional[int] = None, synthetic_clips: int = 32) -> WhaleCallData:
    """The recordings when the nocall directory exists, else the synthetic
    stand-in (with a warning when a directory was named)."""
    if nocall_dir and os.path.isdir(nocall_dir):
        return WhaleCallData(nocall_dir, shotgun_dir, upcall_dir, filter_length=filter_length)
    if nocall_dir:
        print(f"warning: {nocall_dir} not found; using the synthetic whale-call stand-in")
    return WhaleCallData(filter_length=filter_length, synthetic_clips_per_class=synthetic_clips)


def collect_whale_arrays(data: WhaleCallData, mode: str = "train", max_batches: Optional[int] = None,
                         device: DeviceLike = None) -> Tuple[torch.Tensor, np.ndarray, SpectStats]:
    """(images ``(N, 256, 256, 1)`` in [-1, 1] on ``device``, the call types'
    one-hots, the statistics of these spectrograms)."""
    device = resolve_device(device)
    spects, calls = [], []
    for i, batch in enumerate(data.stream(batch_size=64, mode=mode, device=device)):
        spects.append(batch["audio"])
        calls.append(batch["call_type"])
        if max_batches and i + 1 >= max_batches:
            break
    spects = torch.cat(spects)
    stats = SpectStats.compute(spects)
    return stats.spect_to_img(spects)[..., None], np.concatenate(calls).astype(np.float32), stats


def load_esrf_dataset(wav_dir: Optional[str], label_csv: Optional[str],
                      synthetic_recordings: int = 24) -> EsrfStation:
    """The station when its directory exists, else the synthetic stand-in
    (with a warning when a directory was named)."""
    if wav_dir and os.path.isdir(wav_dir):
        return EsrfStation(wav_dir, label_csv)
    if wav_dir:
        print(f"warning: {wav_dir} not found; using the synthetic ESRF stand-in")
    return EsrfStation(synthetic_recordings=synthetic_recordings)


def collect_esrf_spectrograms(data: EsrfStation, max_batches: Optional[int] = None,
                              device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """(the training windows' log-spectrograms ``(N, 512, 512)`` on
    ``device``, their ``has_boat`` one-hots and scaled ``closest_boat``),
    from batches of 32 recordings' windows, at most ``max_batches``."""
    device = resolve_device(device)
    spects, boats, dists = [], [], []
    for i, batch in enumerate(data.stream(batch_size=32, mode="train", device=device)):
        spects.append(batch["audio"])
        boats.append(batch["has_boat"])
        dists.append(batch["closest_boat"])
        if max_batches and i + 1 >= max_batches:
            break
    attrs = {"has_boat": np.concatenate(boats).astype(np.float32),
             "closest_boat": np.concatenate(dists).astype(np.float32)}
    return torch.cat(spects), attrs


# ------------------------------------------------------------------ BiGAN


def save_whale_bigan(path: str, state: Mapping, stats: SpectStats, meta: Optional[Dict] = None,
                     kind: str = "bigan-whale"):
    """A ``GANTrainer.state_dict()`` (or a part of one: the ESRF fine-tune
    keeps E and G) and the statistics, under the meta ``kind``
    (``bigan-esrf`` for the ESRF BiGAN's files)."""
    save_spect_trainer(path, state, stats, kind, meta)


def _bigan_state_from_jax(tree: Mapping, meta: Dict) -> Dict:
    if "vars_D" in tree:
        return gan_state_from_jax(tree)
    return {"E": encoder_state_dict_from_jax(tree["params_E"]), "G": generator_state_dict_from_jax(tree["params_G"])}


def load_whale_bigan(path: str, device: DeviceLike = None) -> Tuple[Dict, SpectStats, Dict]:
    """``(trainer state, statistics on device, meta)`` of either kind of
    whale or ESRF BiGAN file, the state in ``GANTrainer.state_dict()``'s
    form (from a JAX file: no generator). A file that holds E and G alone
    (the ESRF fine-tune's) gives a state of those two. A file without
    statistics raises ``cli.common.MissingStatsError``, as the JAX loader
    does."""
    return load_spect_trainer(path, _bigan_state_from_jax, device, need_stats=True)


# ------------------------------------------------------------ classifier


def save_whale_classifier(path: str, state: Mapping, stats: SpectStats, width: float) -> None:
    """A ``SupervisedTrainer.state_dict()`` of the NARW classifier and the
    statistics it trained on."""
    save_spect_classifier(path, state, stats, {"kind": "whale-clf", "width": width})


def load_whale_classifier(path: str, device: DeviceLike = None) -> Tuple[CNNClassifier, Dict]:
    """``(the NARW classifier in eval mode, meta)`` of either kind of file,
    at the width its meta names."""
    model, _, meta = load_spect_classifier(
        path, lambda m: narw_classifier_config(3, width=m.get("width", 1.0)), device)
    return model, meta


# ------------------------------------------------------------------ VAE


def save_whale_vae(path: str, state: Mapping, stats: SpectStats, meta: Optional[Dict] = None) -> None:
    """A ``VAETrainer.state_dict()`` and the statistics."""
    save_spect_trainer(path, state, stats, "vae-whale", meta)


def load_whale_vae_state(path: str, device: DeviceLike = None) -> Tuple[Optional[Dict], Dict]:
    """``(trainer state, meta)`` of either kind of ``whale-vae.tar``, the
    state in ``VAETrainer.state_dict()``'s form (from a JAX file: no
    generator); None for a JAX file that carries no optimiser state."""
    state, _, meta = load_spect_trainer(path, vae_state_from_jax, device)
    return state, meta


def load_whale_vae(path: str, device: DeviceLike = None) -> Tuple[ConditionalVAE, Dict]:
    """``(the whale VAE in eval mode, meta)`` of either kind of file, at the
    ``d`` its meta names."""
    model, _, meta = load_spect_vae(path, lambda m: whale_vae_config(d=m.get("d", 64)), device)
    return model, meta
