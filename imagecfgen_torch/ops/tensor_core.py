"""What the two tensor-core kernels share on the Python side: the launch
plan, the packed weight layout, the TF32 hi/lo split and a per-tensor cache.

``csrc/tc_gemm.cuh`` computes ``y = act(A @ B^T + b)`` with ``A (M, K)``
gathered from an NHWC input and ``B (N, K)`` packed K-major. Everything that
needs no card is kept here, where the CPU tests reach it:

- :func:`plan_gemm`: tile shape, K split and gather path of one layer, a
  pure function of its shape, its type and the card's SM count;
- :func:`pack_conv_weight` / :func:`pack_rows`: the ``(N, Kp)`` layout the
  kernel reads (``ci`` fastest, as NHWC stores it; K padded with zeros to a
  multiple of the slice depth), for float32 split into TF32 ``hi`` and
  ``lo`` parts (3xTF32: ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi``);
- :func:`cached`: a value derived from a tensor, remembered until that
  tensor is updated in place, reloaded or freed.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, Tuple

import torch

#: tile shapes by index, as ``csrc/tc_gemm.cuh::launch_typed`` numbers them:
#: (rows, columns, relative efficiency of the main loop at that shape).
#: The last shape is for layers with the vector gather and tiles to spare:
#: it moves fewer bytes per operation, but measured slower with a K split.
TILES = ((128, 128, 1.0), (128, 64, 0.8), (64, 64, 0.6), (256, 128, 1.2))
UNSPLIT_VECTOR_TILES = (3,)
DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take
MAX_SPLIT = 8          # blocks of one thread-block cluster
MIN_SPLIT_SLICES = 4   # no split leaves a block fewer K slices than this
_FIXED_SLICES = 2.0    # a block's prologue and epilogue, in slices
_REDUCE_SLICES = 2.0   # the cluster's reduction, in slices
#: the instruction of the vector-gather kernel; the scalar-gather kernel uses mma.sync
INSTRUCTION = "wgmma"


def slice_depth(dtype: torch.dtype) -> int:
    """K values per staged slice: 128 bytes a row."""
    if dtype == torch.float32:
        return 32
    if dtype == torch.bfloat16:
        return 64
    raise ValueError(f"the tensor-core kernels take float32 or bfloat16, got {dtype}")


def padded_depth(k: int, dtype: torch.dtype) -> int:
    bk = slice_depth(dtype)
    return -(-k // bk) * bk


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    tile: int      # index into TILES
    bm: int
    bn: int
    split: int     # K split == cluster size
    vec: bool      # 16-byte gathers along the input channels
    blocks: int
    slices: int    # K slices in all

    def describe(self) -> str:
        return (f"{self.bm}x{self.bn} tiles, split {self.split}, {self.blocks} blocks, "
                f"{self.slices} slices, {'vector' if self.vec else 'scalar'} gather")


@functools.lru_cache(maxsize=None)
def plan_gemm(m: int, n: int, k: int, cin: int, dtype: torch.dtype, sms: int) -> GemmPlan:
    """The launch plan of one layer: ``m`` output pixels, ``n`` output
    channels, ``k = kh*kw*cin`` taps. Cost model: every SM runs
    ``ceil(blocks / sms)`` blocks one after the other, a block costs its K
    slices (plus a fixed part, plus the reduction when K is split) times its
    tile's area over that tile's efficiency. The cheapest (tile, split)
    wins; ties go to the larger tile and the smaller split."""
    bk = slice_depth(dtype)
    slices = -(-k // bk)
    best = None
    vec = cin % bk == 0
    for tile, (bm, bn, eff) in enumerate(TILES):
        if tile in UNSPLIT_VECTOR_TILES and not vec:
            continue
        tiles = -(-m // bm) * -(-n // bn)
        for split in range(1, 2 if tile in UNSPLIT_VECTOR_TILES else MAX_SPLIT + 1):
            if split > 1 and slices // split < MIN_SPLIT_SLICES:
                break
            per_block = -(-slices // split) + _FIXED_SLICES + (_REDUCE_SLICES if split > 1 else 0.0)
            cost = -(-tiles * split // sms) * per_block * bm * bn / eff
            if best is None or cost < best[0]:
                best = (cost, GemmPlan(tile, bm, bn, split, vec, tiles * split, slices))
    return best[1]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


@torch.no_grad()
def pack_rows(w2d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``(N, K)`` rows -> the kernel's B operand: ``(N, Kp)`` contiguous,
    zero beyond K; ``(hi, lo)`` for float32, ``(w,)`` for bfloat16. No
    gradient is recorded: the kernels' backward never reads the packed copy."""
    n, k = w2d.shape
    kp = padded_depth(k, w2d.dtype)
    if kp != k:
        w2d = torch.nn.functional.pad(w2d, (0, kp - k))
    w2d = w2d.contiguous()
    return split_tf32(w2d) if w2d.dtype == torch.float32 else (w2d,)


def pack_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """An ``(O, I, kh, kw)`` conv kernel -> ``(O, kh*kw*I)`` with the input
    channel fastest (the order an NHWC patch is read in), then
    :func:`pack_rows`."""
    return pack_rows(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))


# ---------------------------------------------------------------- the cache

_CACHE: Dict[Tuple[int, str], Tuple[Any, tuple, Any]] = {}


def _state(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t._version, t.dtype, tuple(t.shape), t.device)


def cached(t: torch.Tensor, tag: str, make: Callable[[torch.Tensor], Any]) -> Any:
    """``make(t)``, remembered for this tensor object under ``tag`` until
    its storage, version counter (in-place updates, ``load_state_dict``),
    type, shape or device changes; dropped when the tensor is freed."""
    slot = (id(t), tag)
    state = _state(t)
    hit = _CACHE.get(slot)
    if hit is not None and hit[0]() is t and hit[1] == state:
        return hit[2]
    value = make(t)
    _CACHE[slot] = (weakref.ref(t, lambda _, slot=slot: _CACHE.pop(slot, None)), state, value)
    return value


def cast_cached(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself when it has that type; a cached
    copy when no gradient is being recorded; a plain cast otherwise (so
    that a gradient flows to ``t``)."""
    if t.dtype == dtype:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return t.to(dtype)
    return cached(t, f"cast:{dtype}", lambda v: v.detach().to(dtype))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0
