"""AudioMNIST data: the zip's ingest on the host, spectrograms on the device
(port of ``imagecfgen_tpu/data/audio_mnist.py``).

Reads the AudioMNIST zip (60 subjects x 10 digits x 50 runs), resamples to
8 kHz, zero-pads to 8,000 samples, cleans the metadata (spanien -> spain,
german/spanish -> german, age > 100 -> 28), one-hots the five categorical
features, bins the age uniformly into five, and streams batches with runs
or subjects excluded. Without the zip, a deterministic synthetic stand-in
(pure numpy, the JAX package's waveforms bit for bit) takes its place.

The log-spectrogram (``spectrogram_batch``) is computed on the device the
caller names, in batches; ``stream`` and ``all_spectrograms`` return
tensors there.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.stft import StftConfig, griffin_lim, spectrogram

# the train/val split of the image-SCM training code
# (image_scms/audio_mnist.py:18)
VALIDATION_RUNS: List[int] = [38, 7, 42, 10, 14, 18, 20, 22, 28]

SAMPLE_RATE = 8000
N_SAMPLES = 8000
AUDIO_STFT = StftConfig(n_fft=255, win_length=128, pad=96)  # -> (128, 128)
GRIFFIN_LIM_STFT = StftConfig(n_fft=255, win_length=128, pad=0)

CATEGORICAL_FEATURES = ("country_of_origin", "accent", "digit", "native_speaker", "gender")


def spectrogram_batch(audio: torch.Tensor, cfg: StftConfig = AUDIO_STFT) -> torch.Tensor:
    """``(B, T)`` waveforms -> ``(B, F, frames)`` log power spectrograms,
    ``log(Spectrogram(x) + 1e-6)``, on ``audio``'s device."""
    return torch.log(spectrogram(audio, cfg) + 1e-6)


def audio_from_log_spect(log_spec: torch.Tensor, rng: Optional[torch.Generator] = None,
                         n_iter: int = 32, angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse: exp, then Griffin-Lim (built without the explicit pad,
    as the reference's ``GriffinLim`` is). ``angle`` injects the initial
    phase."""
    return griffin_lim(torch.exp(log_spec), GRIFFIN_LIM_STFT, rng=rng, n_iter=n_iter, angle=angle)


def _resample_to_8k(wav: np.ndarray, sr: int) -> np.ndarray:
    """48k -> 8k as the reference does it: FFT-domain
    ``scipy.signal.resample`` (librosa's ``res_type="scipy"``)."""
    if sr == SAMPLE_RATE:
        return wav.astype(np.float32)
    from ..ops.resample import resample

    return resample(wav, sr, SAMPLE_RATE).astype(np.float32)


class OneHotVocab:
    """Sorted-unique vocabulary one-hot codec (sklearn OneHotEncoder
    semantics: categories sorted ascending). ``categories`` may be given
    explicitly to pin the width (the synthetic stand-in pins the real
    dataset's cardinalities so model specs line up)."""

    def __init__(self, values: Sequence, categories: Optional[Sequence] = None):
        self.categories = sorted(set(values)) if categories is None else sorted(categories)
        self.index = {v: i for i, v in enumerate(self.categories)}

    @property
    def n(self) -> int:
        return len(self.categories)

    def encode(self, values) -> np.ndarray:
        out = np.zeros((len(values), self.n), np.float32)
        for i, v in enumerate(values):
            out[i, self.index[v]] = 1.0
        return out

    def decode(self, onehot: np.ndarray) -> list:
        return [self.categories[i] for i in np.asarray(onehot).argmax(axis=1)]


class UniformBinner:
    """KBinsDiscretizer(strategy="uniform", n_bins=5) semantics."""

    def __init__(self, values: np.ndarray, n_bins: int = 5):
        v = np.asarray(values, float)
        self.lo, self.hi = v.min(), v.max()
        self.n_bins = n_bins
        self.edges = np.linspace(self.lo, self.hi, n_bins + 1)

    def encode(self, values) -> np.ndarray:
        v = np.asarray(values, float)
        bins = np.clip(np.digitize(v, self.edges[1:-1]), 0, self.n_bins - 1)
        out = np.zeros((len(v), self.n_bins), np.float32)
        out[np.arange(len(v)), bins] = 1.0
        return out

    def decode(self, onehot: np.ndarray) -> np.ndarray:
        bins = np.asarray(onehot).argmax(axis=1)
        centers = (self.edges[:-1] + self.edges[1:]) / 2.0
        return centers[bins]


class AudioMNISTData:
    """The dataset on the host: raw 8 kHz waveforms and encoded metadata."""

    def __init__(self, path_to_zip: Optional[str] = None, synthetic_runs: int = 4):
        if path_to_zip is not None:
            self._load_zip(path_to_zip)
        else:
            self._load_synthetic(runs=synthetic_runs)
        self._fit_encoders()

    # ------------------------------------------------------------ ingest

    def _load_zip(self, path_to_zip: str) -> None:
        from scipy.io import wavfile

        raw: Dict[str, list] = {
            k: []
            for k in ("audio", "country_of_origin", "native_speaker", "accent",
                      "digit", "age", "gender", "subject", "run")
        }
        with zipfile.ZipFile(path_to_zip, "r") as zf:
            meta = json.loads(zf.read("data/audioMNIST_meta.txt").decode("utf-8"))
            names = set(zf.namelist())
            # subjects/digits/runs come from the archive itself (the real
            # dataset is the full 60 x 10 x 50 grid the reference hard-codes
            # at image_scms/audio_mnist.py:69-76; discovering them makes
            # partial fixtures loadable without changing real-data behavior)
            for name in sorted(meta.keys()):
                subject_num = int(name)
                sm = meta[name]
                country = sm["origin"].split(", ")[1].lower()
                if country == "spanien":
                    country = "spain"
                accent = sm["accent"].lower()
                if accent == "german/spanish":
                    accent = "german"
                age = int(sm["age"])
                if age > 100:  # known metadata error
                    age = 28
                for dig in range(10):
                    for run in range(50):
                        fname = f"data/{name}/{dig}_{name}_{run}.wav"
                        if fname not in names:
                            continue
                        sr, wav = wavfile.read(io.BytesIO(zf.read(fname)))
                        wav = _resample_to_8k(wav, sr)
                        if len(wav) > N_SAMPLES:
                            raise ValueError("data length cannot exceed padding length")
                        buf = np.zeros(N_SAMPLES, np.float32)
                        buf[: len(wav)] = wav
                        raw["audio"].append(buf)
                        raw["country_of_origin"].append(country)
                        raw["native_speaker"].append(sm["native speaker"])
                        raw["accent"].append(accent)
                        raw["digit"].append(dig)
                        raw["age"].append(age)
                        raw["gender"].append(sm["gender"])
                        raw["subject"].append(subject_num)
                        raw["run"].append(run)
        self.raw = {k: np.asarray(v) for k, v in raw.items()}
        self.raw["audio"] = np.stack(raw["audio"], axis=0)

    def _load_synthetic(self, runs: int = 4) -> None:
        """Deterministic stand-in: per-digit fundamental + per-subject
        harmonics; metadata with real causal structure (country drives
        native_speaker and accent) so SCM fitting has signal."""
        countries = ["germany", "spain", "france", "italy", "china", "brazil",
                     "egypt", "india", "japan", "kenya", "mexico", "norway", "turkey"]
        accents = ["german", "spanish", "french", "italian", "chinese", "portuguese",
                   "arabic", "hindi", "japanese", "swahili", "mexican", "norwegian",
                   "turkish", "english", "other"]
        # pin full vocabularies so one-hot widths match the real dataset's
        # cardinalities (13 countries, 15 accents, ... — scm/audio_mnist.py)
        self._fixed_categories = {
            "country_of_origin": countries,
            "accent": accents,
            "digit": list(range(10)),
            "native_speaker": ["no", "yes"],
            "gender": ["female", "male"],
        }
        raw = {k: [] for k in ("audio", "country_of_origin", "native_speaker",
                               "accent", "digit", "age", "gender", "subject", "run")}
        t = np.arange(N_SAMPLES) / SAMPLE_RATE
        for subject in range(1, 61):
            srng = np.random.default_rng(subject)
            country = countries[srng.integers(0, len(countries))]
            is_german = country == "germany"
            native = "yes" if (is_german or srng.uniform() < 0.2) else "no"
            if native == "yes" and is_german:
                accent = "german"
            elif srng.uniform() < 0.7:
                accent = accents[countries.index(country)]
            else:
                accent = "english"
            age = int(srng.integers(20, 61))
            gender = "male" if srng.uniform() < 0.6 else "female"
            # subject identity lives in timbre (harmonic amplitude profile
            # + a small pitch offset), NOT in the class-defining
            # fundamental: an earlier design used
            # f = (90 + 3*subject)*(1 + 0.35*digit), which confounds digit
            # with subject (overlapping frequency ranges across digits) and
            # caps any digit classifier near chance on held-out runs.
            a2 = 0.25 + 0.5 * srng.uniform()
            a3 = 0.10 + 0.35 * srng.uniform()
            pitch_shift = 1.0 + 0.02 * srng.normal()
            for dig in range(10):
                # digit -> fixed fundamental (150..690 Hz, well under the
                # 4 kHz Nyquist) + digit-dependent burst count, mimicking
                # how spoken digits differ in phoneme structure
                f = 150.0 * (1.0 + 0.40 * dig) * pitch_shift
                n_bursts = 1 + dig % 3
                for run in range(runs):
                    rr = np.random.default_rng(subject * 100 + dig * 10 + run)
                    dur = int(N_SAMPLES * rr.uniform(0.5, 0.95))
                    env = np.hanning(dur)
                    if n_bursts > 1:
                        env = env * (
                            1.0 - 0.85 * np.sin(np.pi * n_bursts * np.arange(dur) / dur) ** 2
                        )
                    sig = np.zeros(N_SAMPLES, np.float32)
                    tone = (
                        np.sin(2 * np.pi * f * t[:dur])
                        + a2 * np.sin(2 * np.pi * 2 * f * t[:dur])
                        + a3 * np.sin(2 * np.pi * 3 * f * t[:dur])
                    )
                    sig[:dur] = (env * tone + 0.02 * rr.normal(0, 1, dur)).astype(np.float32)
                    raw["audio"].append(sig)
                    raw["country_of_origin"].append(country)
                    raw["native_speaker"].append(native)
                    raw["accent"].append(accent)
                    raw["digit"].append(dig)
                    raw["age"].append(age)
                    raw["gender"].append(gender)
                    raw["subject"].append(subject)
                    raw["run"].append(run)
        self.raw = {k: np.asarray(v) for k, v in raw.items()}
        self.raw["audio"] = np.stack(raw["audio"], axis=0)

    # ------------------------------------------------------------ splits

    @property
    def validation_runs(self) -> List[int]:
        """VALIDATION_RUNS restricted to the runs present; the last observed
        run when none is (the synthetic stand-in has few runs)."""
        observed = set(int(r) for r in np.unique(self.raw["run"]))
        present = [r for r in VALIDATION_RUNS if r in observed]
        return present if present else [max(observed)]

    @property
    def training_excluded_runs(self) -> List[int]:
        return self.validation_runs

    @property
    def validation_excluded_runs(self) -> List[int]:
        observed = set(int(r) for r in np.unique(self.raw["run"]))
        return sorted(observed - set(self.validation_runs))

    # ------------------------------------------------------------ encoders

    def _fit_encoders(self) -> None:
        fixed = getattr(self, "_fixed_categories", {})
        self.vocabs: Dict[str, OneHotVocab] = {
            k: OneHotVocab(self.raw[k].tolist(), categories=fixed.get(k))
            for k in CATEGORICAL_FEATURES
        }
        self.age_binner = UniformBinner(self.raw["age"], n_bins=5)

    def encode_attrs(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {
            k: self.vocabs[k].encode(self.raw[k][idx].tolist())
            for k in CATEGORICAL_FEATURES
        }
        out["age"] = self.age_binner.encode(self.raw["age"][idx])
        return out

    @property
    def attribute_dims(self) -> Dict[str, int]:
        dims = {k: v.n for k, v in self.vocabs.items()}
        dims["age"] = self.age_binner.n_bins
        return dims

    # ------------------------------------------------------------ streaming

    def split_indices(self, excluded_runs: Optional[Sequence[int]] = None) -> np.ndarray:
        return np.nonzero(~np.isin(self.raw["run"], np.asarray(excluded_runs or [])))[0]

    def spectrograms(self, idx: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
        """The log-spectrograms ``(len(idx), F, T)`` of rows ``idx``,
        computed on ``device``."""
        return spectrogram_batch(torch.from_numpy(self.raw["audio"][idx]).to(resolve_device(device)))

    def stream(
        self,
        batch_size: int = 128,
        excluded_runs: Optional[Sequence[int]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> Iterator[Dict]:
        """Shuffled dict batches; ``audio`` is the log-spectrogram tensor on
        ``device``."""
        idx = np.random.default_rng(seed).permutation(self.split_indices(excluded_runs))
        for i in range(0, len(idx), batch_size):
            sel = idx[i : i + batch_size]
            batch: Dict = {"subject": self.raw["subject"][sel], "run": self.raw["run"][sel]}
            batch.update(self.encode_attrs(sel))
            batch["audio"] = self.spectrograms(sel, device)
            yield batch

    def all_spectrograms(
        self,
        excluded_runs: Optional[Sequence[int]] = None,
        batch_size: int = 512,
        device: DeviceLike = None,
    ):
        """(log-spectrograms ``(N, F, T)`` float32 on ``device``, the
        attributes' one-hots (numpy), row indices), computed ``batch_size``
        clips at a time."""
        idx = self.split_indices(excluded_runs)
        device = resolve_device(device)
        out = torch.empty((len(idx), AUDIO_STFT.n_freqs, AUDIO_STFT.n_frames(N_SAMPLES)), device=device)
        for i in range(0, len(idx), batch_size):
            out[i : i + batch_size] = self.spectrograms(idx[i : i + batch_size], device)
        return out, self.encode_attrs(idx), idx
