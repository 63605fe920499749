"""Height-sharded convolution with a halo exchange (port of
``imagecfgen_tpu/parallel/spatial.py``).

Each rank holds rows ``[r H/W, (r+1) H/W)`` of an NHWC activation. Before the
conv it receives ``padding`` rows from the previous rank and ``k - 1 -
padding`` rows from the next (``dist.batch_isend_irecv``, one exchange with
each neighbour), and the two edge ranks take zero rows where a global conv
would see its zero padding; the conv then runs on the rank's rows with the
height padding already in place (``ops.conv.conv2d``, the port's layouts).
The result is the rank's rows of the global conv's output when the shards
tile evenly: ``kernel - 2 padding == stride`` for stride 2 and ``kernel ==
2 padding + 1`` for stride 1; :func:`make_spatial_conv` refuses any other
conv, as the JAX package's does. The MNIST encoder's k4 s2 p1 convs meet the
first condition. The audio, whale and ESRF trunks' k5 s2 p1 convs meet
neither; of those models' convs only the 1x1 stride-1 heads do. No trainer
calls it: data parallelism carries training.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops.conv import conv2d
from .mesh import DataMesh


def _halo_exchange(x: torch.Tensor, lo: int, hi: int, mesh: DataMesh) -> torch.Tensor:
    """``x`` with ``lo`` rows of the previous rank above it and ``hi`` rows
    of the next below it (zero rows at the ends of the height axis)."""
    b, _, w, c = x.shape
    prev, nxt = x.new_zeros((b, lo, w, c)), x.new_zeros((b, hi, w, c))
    r, n, g = mesh.rank, mesh.world, mesh.group
    ops = []
    if g is not None:
        peer = functools.partial(dist.get_global_rank, g)
        if lo and r + 1 < n:
            ops.append(dist.P2POp(dist.isend, x[:, -lo:].contiguous(), peer(r + 1), g, tag=0))
        if lo and r > 0:
            ops.append(dist.P2POp(dist.irecv, prev, peer(r - 1), g, tag=0))
        if hi and r > 0:
            ops.append(dist.P2POp(dist.isend, x[:, :hi].contiguous(), peer(r - 1), g, tag=1))
        if hi and r + 1 < n:
            ops.append(dist.P2POp(dist.irecv, nxt, peer(r + 1), g, tag=1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([prev, x, nxt], dim=1)


def sharded_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                   mesh: DataMesh) -> torch.Tensor:
    """The height-sharded conv of the local shard ``x`` ``(B, H/W, W, C)``
    with ``w`` ``(O, C, k, k)``: this rank's rows of
    ``conv2d(x_global, w, stride, padding)`` where the conv tiles evenly."""
    if x.shape[1] % stride:
        raise ValueError(f"{x.shape[1]} rows a shard do not divide by the stride {stride}")
    k = w.shape[2]
    return conv2d(_halo_exchange(x, padding, k - 1 - padding, mesh), w, stride, (0, padding))


def make_spatial_conv(mesh: DataMesh, stride: int, padding: int,
                      kernel: Optional[int] = None) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``fn(x_local, w)``: the height-sharded conv over ``mesh``. With
    ``kernel`` given, a conv whose shards would not tile is refused here."""
    if kernel is not None:
        if stride > 1 and kernel - 2 * padding != stride:
            raise ValueError(f"conv k={kernel} s={stride} p={padding} does not tile evenly across "
                             "height shards (need kernel - 2*padding == stride)")
        if stride == 1 and kernel != 2 * padding + 1:
            # stride 1 emits H/W rows a shard: a global conv's only for odd
            # 'same' kernels
            raise ValueError(f"conv k={kernel} s=1 p={padding} does not tile evenly across "
                             "height shards (need kernel == 2*padding + 1)")
    return functools.partial(sharded_conv2d, stride=stride, padding=padding, mesh=mesh)
