"""STFT, inverse STFT and Griffin-Lim in torchaudio's conventions
(port of ``imagecfgen_tpu/ops/stft.py``).

Conventions, as the JAX package's:

- an explicit zero ``pad`` on both ends of the signal, then a reflect pad
  of ``n_fft // 2`` (``center``);
- a periodic Hann window of ``win_length`` zero-centred inside ``n_fft``
  (``n_fft = 255``, ``win_length = 128``: 63 zeros on the left, 64 on the
  right);
- a power spectrogram (``|.|^2``) by default;
- Griffin-Lim with momentum 0.99, a random initial phase and 32 iterations.

``stft`` is ``torch.stft`` (cuFFT on the card; the JAX package's is an XLA
FFT, no Pallas kernel), and :func:`stft_reference` is the plain framing +
``torch.fft.rfft`` version of the same function. ``istft`` is the JAX
package's overlap-add, written out: ``torch.istft`` checks the window's
overlap-add envelope over the whole padded signal and refuses the
128-in-255 window, whose envelope is zero at the padded ends. Everything
runs on the device of its input; the JAX package's ``host_prep`` (which
moved the transform to the host's CPU backend for the TPU's sake) has no
counterpart: callers compute spectrograms on the device they name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True, device=None) -> torch.Tensor:
    """``0.5 * (1 - cos(2 pi n / (N - 1)))`` in float32, over ``win_length +
    1`` points cut to ``win_length`` when ``periodic``."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / (n - 1)))
    return w[:win_length] if periodic else w


@dataclasses.dataclass(frozen=True)
class StftConfig:
    n_fft: int = 255
    win_length: int = 128
    hop_length: Optional[int] = None  # default win_length // 2 (torchaudio)
    pad: int = 0  # extra zero padding on both ends
    power: float = 2.0
    center: bool = True

    @property
    def hop(self) -> int:
        return self.hop_length if self.hop_length is not None else self.win_length // 2

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def n_frames(self, n_samples: int) -> int:
        n = n_samples + 2 * self.pad
        if self.center:
            n += 2 * (self.n_fft // 2)
        return 1 + (n - self.n_fft) // self.hop

    def padded_window(self, device=None) -> torch.Tensor:
        """The ``win_length`` window zero-centred in an ``n_fft`` frame."""
        left = (self.n_fft - self.win_length) // 2
        return F.pad(hann_window(self.win_length, device=device),
                     (left, self.n_fft - self.win_length - left))


def _padded(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """The explicit zero pad, then the centre's reflect pad, on the last axis."""
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    if cfg.pad:
        x = F.pad(x, (cfg.pad, cfg.pad))
    if cfg.center:
        c = cfg.n_fft // 2
        x = F.pad(x, (c, c), mode="reflect")
    return x.reshape(*lead, x.shape[-1])


def stft(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """``(..., T)`` float -> complex ``(..., n_freqs, n_frames)``."""
    lead, padded = x.shape[:-1], _padded(x, cfg)
    spec = torch.stft(padded.reshape(-1, padded.shape[-1]), cfg.n_fft, hop_length=cfg.hop, win_length=cfg.n_fft,
                      window=cfg.padded_window(x.device), center=False, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def stft_reference(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """The plain version of :func:`stft`: frames gathered by ``unfold``,
    windowed, ``torch.fft.rfft``."""
    frames = _padded(x, cfg).unfold(-1, cfg.n_fft, cfg.hop) * cfg.padded_window(x.device)
    return torch.fft.rfft(frames, n=cfg.n_fft, dim=-1).transpose(-1, -2)


def spectrogram(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Power (or magnitude) spectrogram, ``(..., n_freqs, n_frames)``."""
    s = stft(x, cfg).abs()
    return s if cfg.power == 1.0 else s ** cfg.power


def istft(spec: torch.Tensor, cfg: StftConfig, length: Optional[int] = None) -> torch.Tensor:
    """Complex ``(..., n_freqs, n_frames)`` -> ``(..., T)``: windowed
    overlap-add, divided by the overlap-added squared window (floored at
    1e-11), the centre and explicit pads cut off."""
    win = cfg.padded_window(spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=cfg.n_fft, dim=-1) * win
    lead, nf = frames.shape[:-2], frames.shape[-2]
    total = cfg.n_fft + cfg.hop * (nf - 1)
    fold = dict(output_size=(1, total), kernel_size=(1, cfg.n_fft), stride=(1, cfg.hop))
    cols = frames.reshape(-1, nf, cfg.n_fft).transpose(1, 2)  # (N, n_fft, frames)
    out = F.fold(cols, **fold).reshape(-1, total)
    norm = F.fold((win * win)[None, :, None].expand(1, cfg.n_fft, nf), **fold).reshape(total)
    out = (out / torch.clamp(norm, min=1e-11)).reshape(*lead, total)
    start = (cfg.n_fft // 2 if cfg.center else 0) + cfg.pad
    end = total - start if length is None else start + length
    return out[..., start:end]


def griffin_lim(spec: torch.Tensor, cfg: StftConfig, rng: Optional[torch.Generator] = None,
                n_iter: int = 32, momentum: float = 0.99, length: Optional[int] = None,
                angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase reconstruction from a power (or magnitude) spectrogram, as
    torchaudio's ``GriffinLim``: the initial phase U(-pi, pi) (drawn from
    ``rng`` on the host, or injected as ``angle``), then ``n_iter`` rounds of
    ``rebuilt - m * prev`` with ``m = momentum / (1 + momentum)``."""
    mag = spec ** (1.0 / cfg.power)
    if angle is None:
        angle = torch.rand(mag.shape, generator=rng) * (2 * math.pi) - math.pi
    s = torch.polar(mag, angle.to(mag.device, mag.dtype))
    prev = torch.zeros_like(s)
    m = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        rebuilt = stft(istft(s, cfg, length=length), cfg)
        update = rebuilt - m * prev
        s = mag * (update / torch.clamp(update.abs(), min=1e-16))
        prev = rebuilt
    return istft(s, cfg, length=length)
