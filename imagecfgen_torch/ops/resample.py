"""Audio resampling on the host, for the dataset's ingest (a numpy copy of
``imagecfgen_tpu/ops/resample.py``; the port imports nothing of the JAX
package).

The reference resamples AudioMNIST wavs 48 kHz -> 8 kHz with librosa's
``res_type="scipy"``, which is FFT-domain ``scipy.signal.resample``:
:func:`resample_fft` is that, exactly, and :func:`resample`'s default. Two
windowed-sinc filters are offered beside it:

- :func:`resample_kaiser_best`: resampy's published ``kaiser_best`` spec (64
  zero crossings a side, Kaiser beta 14.7697, roll-off 0.9475), evaluated
  exactly rather than from resampy's interpolated table: librosa's default
  ``res_type``;
- :func:`resample_poly`: ``scipy.signal.resample_poly``'s default
  semantics (window ``('kaiser', 5.0)``, 10 * max(up, down) taps a side,
  the filter's delay centred).

They run once a wav, on the host: plain numpy.
"""
from __future__ import annotations

from math import gcd

import numpy as np


def _kaiser_lowpass(numtaps: int, cutoff: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass FIR with DC gain 1; ``cutoff`` in
    Nyquist units (1.0 = Nyquist), as scipy ``firwin``'s ``fs=2``."""
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    h *= np.kaiser(numtaps, beta)
    return h / h.sum()


def _upfirdn(x: np.ndarray, h: np.ndarray, up: int, down: int, delay: int, n_out: int) -> np.ndarray:
    """Each row of ``x`` zero-stuffed by ``up``, filtered by ``h``, then
    every ``down``-th sample from ``delay`` on, ``n_out`` of them."""
    n = x.shape[-1]
    batch = x.reshape((-1, n))
    out = np.empty((batch.shape[0], n_out), dtype=np.float64)
    for i, row in enumerate(batch):
        xu = np.zeros(n * up, dtype=np.float64)
        xu[::up] = row
        out[i] = np.convolve(xu, h)[delay: delay + n_out * down: down]
    return out.reshape(x.shape[:-1] + (n_out,))


def resample_poly(x: np.ndarray, up: int, down: int, beta: float = 5.0) -> np.ndarray:
    """Resample ``x`` by ``up / down`` along its last axis, as
    ``scipy.signal.resample_poly(x, up, down)``: ``ceil(len * up / down)``
    samples, sample k the centred-filtered signal at input time
    ``k * down / up``."""
    x = np.asarray(x, dtype=np.float64)
    g = gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x.copy()
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _kaiser_lowpass(2 * half_len + 1, 1.0 / max_rate, beta) * up
    return _upfirdn(x, h, up, down, half_len, -(-x.shape[-1] * up // down))


# resampy's "kaiser_best" window: the filter behind librosa.core.resample's
# default res_type when the reference was written
KAISER_BEST = {"num_zeros": 64, "beta": 14.769656459379492, "rolloff": 0.9475}


def _kaiser_taper(u: np.ndarray, beta: float) -> np.ndarray:
    """The continuous Kaiser window ``I0(beta sqrt(1 - u^2)) / I0(beta)`` on
    ``|u| <= 1``."""
    u = np.clip(u, -1.0, 1.0)
    return np.i0(beta * np.sqrt(1.0 - u * u)) / np.i0(beta)


def resample_kaiser_best(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Resample by ``up / down`` with resampy's kaiser_best windowed sinc,
    evaluated exactly at every offset (resampy interpolates a table of it
    2**9 entries a zero crossing). Output grid and length as librosa's:
    sample k at input time ``k * down / up``, ``ceil(len * up / down)``
    samples. Downsampling stretches the kernel by ``down / up`` (its cutoff
    follows the output's Nyquist) and scales it by ``up / down`` (DC gain 1)."""
    x = np.asarray(x, dtype=np.float64)
    g = gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x.copy()
    nz, beta, roll = KAISER_BEST["num_zeros"], KAISER_BEST["beta"], KAISER_BEST["rolloff"]
    scale = min(up / down, 1.0)
    half = int(np.ceil(nz * up / scale))  # support |scale t| <= num_zeros on the up-rate grid
    t = np.arange(-half, half + 1, dtype=np.float64) / up  # in input samples
    h = scale * roll * np.sinc(roll * scale * t) * _kaiser_taper(scale * t / nz, beta)
    return _upfirdn(x, h, up, down, half, -(-x.shape[-1] * up // down))


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


def resample(wav: np.ndarray, sr_in: int, sr_out: int, beta: float = 5.0, filter: str = "fft") -> np.ndarray:
    """Rate to rate (e.g. 48000 -> 8000). ``filter``: ``"fft"`` (the
    default, the reference's own path: :func:`resample_fft` to
    ``ceil(len * sr_out / sr_in)`` samples), ``"kaiser_best"``
    (:func:`resample_kaiser_best`) or ``"scipy_poly"`` (:func:`resample_poly`
    with a Kaiser window of ``beta``). ``"scipy"`` is refused: librosa's
    ``res_type="scipy"`` is the FFT path, and a polyphase alias would hand
    back the other kernel."""
    wav = np.asarray(wav, dtype=np.float64)
    if sr_in == sr_out:
        return wav.copy()
    g = gcd(sr_in, sr_out)
    if filter == "fft":
        return resample_fft(wav, int(np.ceil(wav.shape[-1] * sr_out / sr_in)))
    if filter == "kaiser_best":
        return resample_kaiser_best(wav, sr_out // g, sr_in // g)
    if filter == "scipy":
        raise ValueError('filter="scipy" is ambiguous: use "fft" (librosa res_type="scipy" semantics, '
                         'the default) or "scipy_poly" (resample_poly)')
    if filter == "scipy_poly":
        return resample_poly(wav, sr_out // g, sr_in // g, beta=beta)
    raise ValueError(f"unknown filter {filter!r}")
