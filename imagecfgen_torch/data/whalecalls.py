"""NARW whale-call data: the event logs and recordings on the host,
spectrograms on the device (port of ``imagecfgen_tpu/data/whalecalls.py``).

Rebuild of the reference ``WhaleCallData`` (``image_scms/whalecalls.py:
38-227``): MATLAB ``.mat`` event logs give the call times, 3-second windows
are cut around each event (zero-padded or truncated to exactly 3 s), upcalls
are filtered by signal-to-noise ratio, an optional moving-average filter
runs over each window, and the train/validation split is by recording.
``Spectrogram(n_fft=511, win_length=128, hop_length=24, pad=64)`` turns a
window of 6,000 samples into a 256 x 256 log image. Without the recordings,
a synthetic stand-in (tonal upsweeps, broadband impulses, noise; the JAX
package's clips bit for bit from the same seed) takes their place.

The JAX package computes the loaders' spectrograms on the host's CPU
backend (``host_prep``); here ``stream`` computes them on the device the
caller names and returns them there.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.stft import StftConfig, griffin_lim, spectrogram

WHALE_STFT = StftConfig(n_fft=511, win_length=128, hop_length=24, pad=64)
WHALE_GL_STFT = StftConfig(n_fft=511, win_length=128, hop_length=24, pad=0)
# NARW hydrophone recordings are 2 kHz: 3 s = 6,000 samples, which the
# reference's Spectrogram(511/128/24, pad=64) turns into 256 frames beside
# its 256 frequency bins
SAMPLE_RATE = 2000
WINDOW_SECONDS = 3
N_SAMPLES = WINDOW_SECONDS * SAMPLE_RATE
CALL_TYPES = ("nocall", "shotgun", "upcall")


def whale_spectrogram_batch(audio: torch.Tensor, cfg: StftConfig = WHALE_STFT) -> torch.Tensor:
    """``(B, 6000)`` windows -> ``(B, 256, 256)`` log power spectrograms,
    ``log(Spectrogram(x) + 1e-6)``, on ``audio``'s device."""
    return torch.log(spectrogram(audio, cfg) + 1e-6)


def whale_audio_from_log_spect(log_spec: torch.Tensor, rng: Optional[torch.Generator] = None,
                               n_iter: int = 32, angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse: exp, then Griffin-Lim without the explicit pad.
    ``angle`` injects the initial phase."""
    return griffin_lim(torch.exp(log_spec), WHALE_GL_STFT, rng=rng, n_iter=n_iter, angle=angle)


def signaltonoise(a: np.ndarray, axis=0, ddof=0) -> np.ndarray:
    """mean / std (the deprecated ``scipy.stats.signaltonoise`` that the
    reference re-implements, ``whalecalls.py:31-35``); 0 where std is 0."""
    a = np.asanyarray(a)
    m = a.mean(axis)
    sd = a.std(axis=axis, ddof=ddof)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(sd == 0, 0, m / sd)


def _parse_mat_log(path: str) -> np.ndarray:
    """The untagged events' (start, end) times of a MATLAB call log
    (``whalecalls.py:63-87``)."""
    from scipy.io import loadmat

    fname = os.path.split(path)[1]
    event = loadmat(path)[f"Log_{fname[:-4]}"]["event"]
    times = event[0, 0]["time"][0].tolist()
    tags = event[0, 0]["tags"][0].tolist()
    return np.asarray([t for t, tag in zip(times, tags) if len(tag) == 0]).reshape(-1, 2)


class WhaleCallData:
    """The recordings' index (or the stand-in's clips) on the host."""

    def __init__(
        self,
        nocall_directory: Optional[str] = None,
        shotgun_directory: Optional[str] = None,
        upcall_directory: Optional[str] = None,
        validation_split: float = 0.2,
        seed: int = 42,
        filter_length: Optional[int] = None,
        min_upcall_snr: float = -2.0,
        synthetic_clips_per_class: int = 32,
    ):
        self.filter_length = filter_length
        self.min_upcall_snr = min_upcall_snr
        if nocall_directory is None:
            self._load_synthetic(synthetic_clips_per_class, seed, validation_split)
        else:
            self._index_real(nocall_directory, shotgun_directory, upcall_directory,
                             validation_split, seed)

    # ------------------------------------------------------------ real data

    def _index_real(self, nocall_dir, shotgun_dir, upcall_dir, validation_split, seed):
        # the JAX package seeds numpy's global generator here and draws the
        # split and the stream's shuffles from it; one RandomState of that
        # seed draws the same numbers in the same order
        self._np_rng = np.random.RandomState(seed)
        self.call_times: Dict[str, Dict[str, np.ndarray]] = {"shotgun": {}, "upcall": {}}
        for kind, directory in (("shotgun", shotgun_dir), ("upcall", upcall_dir)):
            for path in map(str, Path(directory).rglob("*.mat")):
                date = os.path.split(path)[1].split("_")[1]
                self.call_times[kind][date] = _parse_mat_log(path)

        # permutations in the reference's order (shotgun, upcall, nocall;
        # whalecalls.py:88-111): the same seed gives the same membership
        self.paths: Dict[str, Dict[str, List[str]]] = {}
        for kind, directory in (("shotgun", shotgun_dir), ("upcall", upcall_dir), ("nocall", nocall_dir)):
            wavs = list(map(str, Path(directory).rglob("*.wav")))
            n_train = int(len(wavs) * (1 - validation_split))
            inds = self._np_rng.permutation(len(wavs))
            self.paths[kind] = {"train": [wavs[i] for i in inds[:n_train]],
                                "validation": [wavs[i] for i in inds[n_train:]]}
        self._synthetic = None

    def _times_for(self, kind: str, wav_path: str) -> List[Tuple[float, float]]:
        """Event windows of a 15-minute recording, in seconds from its start
        (``whalecalls.py:113-141``); nocall clips take fixed offsets."""
        if kind == "nocall":
            return [(i, i + 3) for i in range(1, 11)]
        date = os.path.dirname(wav_path).split("_")[-1]
        times = self.call_times[kind][date]
        hhmm = wav_path.split("_")[-1][:-4]
        lower = 3600 * int(hhmm[:2]) + 60 * int(hhmm[2:4])
        upper = lower + 15 * 60
        return [(s - lower, e - lower) for (s, e) in times if lower <= s < upper]

    # ------------------------------------------------------------ synthetic

    def _load_synthetic(self, per_class: int, seed: int, validation_split: float):
        """Tonal upsweeps (upcall), broadband impulses (shotgun), noise
        (nocall): the JAX package's draws, in its order."""
        rng = np.random.default_rng(seed)
        t = np.arange(N_SAMPLES) / SAMPLE_RATE
        clips, labels = [], []
        for ci, kind in enumerate(CALL_TYPES):
            for _ in range(per_class):
                noise = 0.05 * rng.normal(0, 1, N_SAMPLES)
                if kind == "nocall":
                    sig = noise
                elif kind == "shotgun":
                    sig = noise.copy()
                    for c in rng.uniform(0.5, 2.5, 3):
                        idx = int(c * SAMPLE_RATE)
                        dur = int(0.05 * SAMPLE_RATE)
                        sig[idx:idx + dur] += rng.normal(0, 1, dur) * np.exp(-np.linspace(0, 6, dur))
                else:  # upcall: a 100 -> 350 Hz rising chirp mid-window
                    f0, f1 = 100.0, 350.0
                    dur = int(1.0 * SAMPLE_RATE)
                    tt = t[:dur]
                    chirp = np.sin(2 * np.pi * (f0 * tt + (f1 - f0) / 2.0 * tt ** 2))
                    sig = noise.copy()
                    start = int(1.0 * SAMPLE_RATE)
                    sig[start:start + dur] += 0.8 * np.hanning(dur) * chirp
                clips.append(sig.astype(np.float32))
                labels.append(ci)
        clips = np.stack(clips, axis=0)
        labels = np.asarray(labels)
        inds = rng.permutation(len(clips))
        n_train = int(len(clips) * (1 - validation_split))
        self._synthetic = {
            "train": (clips[inds[:n_train]], labels[inds[:n_train]]),
            "validation": (clips[inds[n_train:]], labels[inds[n_train:]]),
        }

    # ------------------------------------------------------------ streaming

    def _clip_audio(self, audio: np.ndarray, sr: int, t0: float, t1: float) -> np.ndarray:
        """The window around ``[t0, t1]`` seconds: centred, moving-average
        filtered when ``filter_length``, zero-padded or cut to 6,000
        samples, float64."""
        pad = max(0.0, (WINDOW_SECONDS - (t1 - t0)) / 2)
        start = max(0, int(sr * (t0 - pad)))
        end = min(len(audio), int(sr * (t1 + pad)))
        a = audio[start:end].astype(np.float64)
        if self.filter_length:
            from scipy import signal

            a = signal.lfilter([1.0 / self.filter_length] * self.filter_length, 1.0, a)
        if len(a) < N_SAMPLES:
            a = np.concatenate([a, np.zeros(N_SAMPLES - len(a))])
        return a[:N_SAMPLES]

    def stream(self, transform: bool = True, batch_size: int = 64, shuffle: bool = True,
               mode: str = "train", seed: int = 0, device: DeviceLike = None) -> Iterator[Dict]:
        """Dict batches of ``call_type`` (one-hot), ``path``, ``time`` and
        ``audio``: with ``transform`` the log-spectrograms ``(B, 256, 256)``
        on ``device`` (the card unless asked otherwise), else the float32
        windows as numpy."""
        device = resolve_device(device) if transform else None
        if self._synthetic is not None:
            clips, labels = self._synthetic["train" if mode == "train" else "validation"]
            idx = np.arange(len(clips))
            if shuffle:
                idx = np.random.default_rng(seed).permutation(idx)
            for i in range(0, len(idx), batch_size):
                sel = idx[i:i + batch_size]
                yield self._batch(clips[sel], np.eye(3, dtype=np.float32)[labels[sel]],
                                  ["synthetic"] * len(sel), np.zeros((len(sel), 2), np.float32),
                                  transform, device)
            return

        from scipy.io import wavfile

        entries = [(ci, kind, p) for ci, kind in enumerate(CALL_TYPES)
                   for p in self.paths[kind]["train" if mode == "train" else "validation"]]
        order = np.arange(len(entries))
        if shuffle:
            self._np_rng.shuffle(order)
        buf = {"audio": [], "call_type": [], "path": [], "time": []}
        for pos in order:
            ci, kind, p = entries[pos]
            sr, audio = wavfile.read(p)
            for t0, t1 in self._times_for(kind, p):
                a = self._clip_audio(audio, sr, t0, t1)
                if kind == "upcall" and signaltonoise(a).max() < self.min_upcall_snr:
                    continue
                buf["audio"].append(a)
                buf["call_type"].append(np.eye(3, dtype=np.float32)[ci])
                buf["path"].append(p)
                buf["time"].append([t0, t1])
                if len(buf["audio"]) >= batch_size:
                    yield self._emit(buf, transform, device)
                    buf = {"audio": [], "call_type": [], "path": [], "time": []}
        if buf["audio"]:
            yield self._emit(buf, transform, device)

    @staticmethod
    def _batch(audio, call_type, path, time, transform, device) -> Dict:
        audio = np.asarray(audio, np.float32)
        return {"call_type": call_type, "path": np.asarray(path), "time": np.asarray(time, np.float32),
                "audio": whale_spectrogram_batch(torch.from_numpy(audio).to(device)) if transform else audio}

    def _emit(self, buf, transform, device) -> Dict:
        return self._batch(np.stack(buf["audio"], axis=0), np.stack(buf["call_type"], axis=0),
                           buf["path"], buf["time"], transform, device)
