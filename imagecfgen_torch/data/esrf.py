"""ESRF hydrophone-station data (boat presence and proximity): the labels and
recordings on the host, spectrograms on the device (port of
``imagecfgen_tpu/data/esrf.py``).

Rebuild of the reference ``EsrfStation`` (``image_scms/esrf_acoustic.py:
32-131``): the label CSV's ``BG*`` distance columns reduce to a
``closest_boat`` scalar (100 - the highest active BG index; -1 when none),
rows at a distance over 30 are dropped, the recordings split by a seeded
permutation, and each recording yields random 5-second windows (10 for a
boat-positive recording, 1 otherwise).
``Spectrogram(n_fft=1023, win_length=256, hop_length=79, pad=200)`` turns a
window of 40,000 samples into a 512 x 512 log image; ``closest_boat`` is
scaled ``2 d / 100 - 1`` with it (``esrf_acoustic.py:124``). Without the
recordings, a synthetic stand-in (a low-frequency harmonic rumble whose
amplitude follows the boat's distance; the JAX package's bit for bit)
takes their place.

Two deviations from the JAX package: the CSV is read with the ``csv``
module and numpy (the card's host has no pandas), and ``stream`` computes
the spectrograms on the device the caller names (the JAX package on the
host's CPU backend, ``host_prep``).
"""
from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.stft import StftConfig, griffin_lim, spectrogram

ESRF_STFT = StftConfig(n_fft=1023, win_length=256, hop_length=79, pad=200)
ESRF_GL_STFT = StftConfig(n_fft=1023, win_length=256, hop_length=79, pad=0)
SAMPLE_RATE = 8000
WINDOW_SECONDS = 5
N_SAMPLES = WINDOW_SECONDS * SAMPLE_RATE


def esrf_spectrogram_batch(audio: torch.Tensor, cfg: StftConfig = ESRF_STFT) -> torch.Tensor:
    """``(B, 40000)`` windows -> ``(B, 512, 512)`` log power spectrograms,
    ``log(Spectrogram(x) + 1e-6)``, on ``audio``'s device."""
    return torch.log(spectrogram(audio, cfg) + 1e-6)


def esrf_audio_from_log_spect(log_spec: torch.Tensor, rng: Optional[torch.Generator] = None,
                              n_iter: int = 32, angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse: exp, then Griffin-Lim without the explicit pad.
    ``angle`` injects the initial phase."""
    return griffin_lim(torch.exp(log_spec), ESRF_GL_STFT, rng=rng, n_iter=n_iter, angle=angle)


def distance_from_bg_columns(bg_matrix: np.ndarray) -> np.ndarray:
    """closest_boat = 100 - the highest active BG index, -1 when no boat
    (``esrf_acoustic.py:49-54``)."""
    out = np.full(len(bg_matrix), -1.0)
    for i, row in enumerate(np.asarray(bg_matrix)):
        active = np.nonzero(row > 0)[0]
        if len(active):
            out[i] = 100 - active.max()
    return out


def _read_labels(path: str):
    """(file names, the ``BG*`` columns as a float matrix) of the label
    CSV, the file names cut to their last path component."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    bg_cols = [c for c in (rows[0].keys() if rows else ()) if c.startswith("BG")]
    names = np.asarray([r["filepath"].split("/")[-1] for r in rows])
    bg = np.asarray([[float(r[c]) if r[c] != "" else np.nan for c in bg_cols] for r in rows],
                    dtype=np.float64).reshape(len(rows), len(bg_cols))
    return names, bg


class EsrfStation:
    """The station's recordings (or the stand-in's) on the host."""

    def __init__(
        self,
        station_wav_path: Optional[str] = None,
        station_label_csv: Optional[str] = None,
        validation_split: float = 0.2,
        seed: int = 42,
        synthetic_recordings: int = 24,
    ):
        if station_wav_path is None:
            self._load_synthetic(synthetic_recordings, seed, validation_split)
        else:
            self._index_real(station_wav_path, station_label_csv, validation_split, seed)

    def _index_real(self, wav_path, label_csv, validation_split, seed):
        names, bg = _read_labels(label_csv)
        dist = distance_from_bg_columns(bg)
        keep = dist <= 30
        names, dist = names[keep], dist[keep]
        has_boat = (dist > 0).astype(float)
        dist = np.where(has_boat > 0, dist, 0.0)
        self.filepaths, self.distance_feature, self.has_boat_flag = names, dist, has_boat

        known = set(names.tolist())
        wavs = [p for p in map(str, Path(wav_path).rglob("*.wav"))
                if "8000" in p and os.path.split(p)[-1] in known]

        def is_positive(p):
            flags = has_boat[names == os.path.split(p)[-1]]
            return len(flags) and flags[0] == 1

        positives = [p for p in wavs if is_positive(p)]
        negatives = [p for p in wavs if not is_positive(p)]
        # the reference's list as it is built (esrf_acoustic.py:68-73):
        # negatives, then the positives under a cap that never binds in
        # practice; the seeded permutation below indexes this list
        wavs = negatives + positives[: 10 * int(has_boat.sum())]
        inds = np.random.RandomState(seed).permutation(len(wavs))
        n_train = int(len(wavs) * (1 - validation_split))
        self.train_paths = [wavs[i] for i in inds[:n_train]]
        self.validation_paths = [wavs[i] for i in inds[n_train:]]
        self._synthetic = None

    def _load_synthetic(self, n_rec: int, seed: int, validation_split: float):
        rng = np.random.default_rng(seed)
        recs = []
        t = np.arange(20 * SAMPLE_RATE) / SAMPLE_RATE
        for _ in range(n_rec):
            has_boat = rng.uniform() < 0.5
            dist = float(rng.integers(5, 31)) if has_boat else 0.0
            noise = 0.05 * rng.normal(0, 1, len(t))
            if has_boat:
                amp = 1.0 - dist / 40.0
                rumble = sum(amp / (h + 1) * np.sin(2 * np.pi * (25.0 * (h + 1)) * t + rng.uniform(0, 6))
                             for h in range(6))
                noise = noise + rumble
            recs.append((noise.astype(np.float32), has_boat, dist))
        inds = rng.permutation(n_rec)
        n_train = int(n_rec * (1 - validation_split))
        self._synthetic = {"train": [recs[i] for i in inds[:n_train]],
                           "validation": [recs[i] for i in inds[n_train:]]}

    # ------------------------------------------------------------ streaming

    def stream(self, transform: bool = True, batch_size: int = 64, shuffle: bool = True,
               mode: str = "train", seed: int = 0, device: DeviceLike = None) -> Iterator[Dict]:
        """Dict batches of ``has_boat`` (one-hot), ``closest_boat``,
        ``start_idx`` and ``audio``. A recording's windows all go into one
        batch, so a batch may hold up to ``batch_size + 9`` rows. With
        ``transform``, ``audio`` holds the log-spectrograms ``(B, 512, 512)``
        on ``device`` (the card unless asked otherwise) and ``closest_boat``
        is scaled to ``2 d / 100 - 1``; else the float32 windows as numpy."""
        device = resolve_device(device) if transform else None
        rng = np.random.default_rng(seed)
        buf = {"audio": [], "closest_boat": [], "has_boat": [], "start_idx": []}

        def emit():
            audio = np.stack(buf["audio"], axis=0).astype(np.float32)
            out = {"has_boat": np.stack(buf["has_boat"], axis=0).astype(np.float32),
                   "closest_boat": np.asarray(buf["closest_boat"], np.float32),
                   "start_idx": np.asarray(buf["start_idx"], np.float32)}
            if transform:
                out["audio"] = esrf_spectrogram_batch(torch.from_numpy(audio).to(device))
                out["closest_boat"] = 2 * out["closest_boat"] / 100.0 - 1.0
            else:
                out["audio"] = audio
            return out

        def push(audio_data, has_boat, dist):
            starts = rng.integers(0, len(audio_data) - N_SAMPLES, size=10 if has_boat else 1)
            onehot = np.zeros(2, np.float32)
            onehot[int(has_boat)] = 1.0
            for s in starts:
                buf["audio"].append(audio_data[s:s + N_SAMPLES])
                buf["has_boat"].append(onehot)
                buf["closest_boat"].append(dist)
                buf["start_idx"].append(s)

        if self._synthetic is not None:
            recs = list(self._synthetic["train" if mode == "train" else "validation"])
            if shuffle:
                rng.shuffle(recs)
            sources = ((lambda r=r: r) for r in recs)
        else:
            from scipy.io import wavfile

            paths = self.train_paths if mode == "train" else self.validation_paths
            order = np.arange(len(paths))
            if shuffle:
                rng.shuffle(order)

            def read(path):
                row = self.filepaths == os.path.split(path)[-1]
                audio = wavfile.read(path)[1][5 * SAMPLE_RATE:]
                return audio, bool(self.has_boat_flag[row][0]), self.distance_feature[row][0]

            sources = ((lambda p=paths[i]: read(p)) for i in order)
        for source in sources:
            push(*source())
            if len(buf["audio"]) >= batch_size:
                yield emit()
                buf = {"audio": [], "closest_boat": [], "has_boat": [], "start_idx": []}
        if buf["audio"]:
            yield emit()
