"""Spectrogram normalisation: the clip(+-3 std)/3 idiom
(port of ``imagecfgen_tpu/ops/spectral.py``).

Per-time-column statistics of the log-spectrograms, reduced over (sample,
frequency), map ``spect_to_img = clip((x - mean) / (std + 1e-6), -3, 3) /
3`` and back. ``compute`` is two-pass, ``E[(X - mean)^2]``, as the JAX
package's; on a shard of the rows it reduces over every rank's rows, as the
JAX package's does on a sharded array.

The zero-pad columns of a spectrogram are near constant: their ``std`` is
rounding noise of order 1e-6, which ``/ (std + 1e-6)`` raises to O(1), so
images there follow the last bits of the statistics.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike

STDS_KEPT = 3.0


@dataclasses.dataclass
class SpectStats:
    mean: torch.Tensor  # (1, 1, T)
    std: torch.Tensor   # (1, 1, T)

    @staticmethod
    def compute(spects: torch.Tensor, mesh=None) -> "SpectStats":
        """``spects``: ``(N, F, T)`` log-spectrograms -> per-time-column
        statistics ``(1, 1, T)``, the variance in two passes. ``mesh`` (a
        ``parallel.DataMesh``): ``spects`` is this rank's shard of the rows,
        and the statistics are those of all the ranks' rows: one all-reduce
        of the rank's means weighted by its row count, and of the count, for
        the mean, and one likewise of the squared deviations for the
        variance, carried in float64 (a constant pad column then keeps its
        value to the last bit). The CLIs hold every row on every rank and
        pass no mesh; the mesh form matches the JAX module's sharded call."""
        if mesh is None or mesh.group is None:
            mean = spects.mean(dim=(0, 1)).reshape(1, 1, -1)
            var = ((spects - mean) ** 2).mean(dim=(0, 1)).reshape(1, 1, -1)
            return SpectStats(mean, torch.sqrt(var))
        count = spects.new_full((1,), spects.shape[0] * spects.shape[1], dtype=torch.float64)

        def global_mean(per_row):  # the ranks' means weighted by their rows, in float64
            total = mesh.sum_(torch.cat([per_row.double().mean(dim=(0, 1)) * count, count]))
            return (total[:-1] / total[-1]).to(spects.dtype).reshape(1, 1, -1)

        mean = global_mean(spects)
        return SpectStats(mean, torch.sqrt(global_mean((spects - mean) ** 2)))

    def to(self, device: DeviceLike) -> "SpectStats":
        return SpectStats(self.mean.to(device), self.std.to(device))

    def spect_to_img(self, spect: torch.Tensor) -> torch.Tensor:
        z = (spect - self.mean) / (self.std + 1e-6)
        return torch.clamp(z, -STDS_KEPT, STDS_KEPT) / STDS_KEPT

    def img_to_spect(self, img: torch.Tensor) -> torch.Tensor:
        return img * STDS_KEPT * (self.std + 1e-6) + self.mean
