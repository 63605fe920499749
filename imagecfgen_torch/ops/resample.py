"""Audio resampling on the host, for the dataset's ingest (a numpy copy of
``imagecfgen_tpu/ops/resample.py``'s FFT path; the port imports nothing of
the JAX package).

The reference resamples AudioMNIST wavs 48 kHz -> 8 kHz with librosa's
``res_type="scipy"``, which is FFT-domain ``scipy.signal.resample``:
:func:`resample_fft` is that, exactly. It runs once a wav, on the host:
plain numpy.
"""
from __future__ import annotations

import numpy as np


def resample_fft(x: np.ndarray, num: int) -> np.ndarray:
    """Resample to ``num`` samples along the last axis via the Fourier
    method, matching ``scipy.signal.resample(x, num)`` exactly: truncate
    (or zero-pad) the spectrum, with the split/doubled Nyquist-bin
    handling for even lengths, and rescale by num/n."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    if num == n:
        return x.copy()
    X = np.fft.fft(x, axis=-1)
    N = min(num, n)
    Y = np.zeros(x.shape[:-1] + (num,), dtype=complex)
    nyq = N // 2 + 1
    Y[..., :nyq] = X[..., :nyq]
    if N > 2:
        Y[..., nyq - N:] = X[..., nyq - N:]
    if N % 2 == 0:
        if num < n:  # downsampling: double the retained Nyquist bin
            Y[..., N // 2] *= 2.0
        else:  # upsampling: split it across the two symmetric positions
            Y[..., N // 2] *= 0.5
            Y[..., num - N // 2] = Y[..., N // 2]
    y = np.fft.ifft(Y, axis=-1).real * (float(num) / n)
    return y


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Rate to rate (e.g. 48000 -> 8000): :func:`resample_fft` to
    ``ceil(len * sr_out / sr_in)`` samples."""
    wav = np.asarray(wav, dtype=np.float64)
    if sr_in == sr_out:
        return wav.copy()
    return resample_fft(wav, int(np.ceil(wav.shape[-1] * sr_out / sr_in)))
