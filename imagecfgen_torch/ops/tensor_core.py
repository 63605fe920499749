"""What the tensor-core kernels share on the Python side: the launch plans,
the packed weight layout, the TF32 hi/lo split and a per-tensor cache.

``csrc/tc_gemm.cuh`` and the two kernels' sources compute ``y = act(A @ B^T
+ b)``: a conv with ``A (M, K)`` gathered from an NHWC input and ``B (N, K)``
packed K-major, or a dense layer. Everything that needs no card is kept
here, where the CPU tests reach it:

- :func:`plan_gemm` (``conv_wgmma``: a conv layer whose input channels are a
  multiple of the slice depth), :func:`plan_window` (``conv_window``: a
  layer whose input channels are not, such as a trunk's first) and
  :func:`plan_dense` (``dense_tma``): pure functions of a layer's shape, its
  type and what the card runs at once;
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
from typing import Any, Callable, Dict, Optional, Tuple

import torch

#: conv_wgmma's tile shapes by index, as ``csrc/tc_gemm.cuh::launch_typed`` numbers them:
#: (rows, columns, relative efficiency of the main loop at that shape).
#: The last shape is for layers with tiles to spare:
#: it moves fewer bytes per operation, but measured slower with a K split.
TILES = ((128, 128, 1.0), (128, 64, 0.8), (64, 64, 0.6), (256, 128, 1.2))
UNSPLIT_TILES = (3,)
#: tiles whose kernel has no registers for the float32 sum promoted out of
#: the tensor cores every K slice (512 threads; ``csrc/tc_gemm.cuh``,
#: Promotion): float32 layers never take them
UNPROMOTED_TILES = (3,)
DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take
MAX_SPLIT = 8          # blocks of one thread-block cluster
MIN_SPLIT_SLICES = 4   # no split leaves a block fewer K slices than this
_FIXED_SLICES = 2.0    # a block's prologue and epilogue, in slices
_REDUCE_SLICES = 2.0   # the cluster's reduction, in slices
#: the instruction of all three kernels
INSTRUCTION = "wgmma"
#: conv_window (``csrc/fused_encoder.cu``): pixel slots of a tile, threads,
#: windows in shared memory (the next tile's in flight), the epilogue's
#: staging (eight warps' 16 pixels x 128 bytes, padded) and the shared memory
#: a block may take (of the 227 KB an H100's block can have)
WINDOW_SLOTS = 128
WINDOW_THREADS = 256
WINDOW_BUFFERS = 2
WINDOW_STAGING = 8 * 16 * 144
WINDOW_SMEM = 220 * 1024
#: dense_tma (``csrc/fused_dense.cu``): w rows a block, and the x rows a
#: block may take (the wgmma's n)
DENSE_WROWS = 64
DENSE_NX = (16, 32, 64, 128)


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
    blocks: int
    slices: int    # K slices in all
    cin: int       # input channels as the kernel reads them

    def describe(self) -> str:
        return (f"conv_wgmma: {self.bm}x{self.bn} tiles, split {self.split}, {self.blocks} blocks, "
                f"{self.slices} slices, {self.cin} input channels")


@functools.lru_cache(maxsize=None)
def plan_gemm(m: int, n: int, k: int, cin: int, dtype: torch.dtype, sms: int) -> GemmPlan:
    """The launch plan of one ``conv_wgmma`` layer: ``m`` output pixels,
    ``n`` output channels, ``k = kh*kw*cin`` taps, ``cin`` a multiple of the
    slice depth (other layers take :func:`plan_window`). Cost model: every
    SM runs ``ceil(blocks / sms)`` blocks one after the other, a block costs
    its K slices (plus a fixed part, plus the reduction when K is split)
    times its tile's area over that tile's efficiency. The cheapest (tile,
    split) wins; ties go to the larger tile and the smaller split. float32
    takes only tiles that promote their sums."""
    bk = slice_depth(dtype)
    if cin % bk:
        raise ValueError(f"conv_wgmma takes input channels in multiples of {bk}, got {cin}")
    slices = -(-k // bk)
    best = None
    for tile, (bm, bn, eff) in enumerate(TILES):
        if tile in UNPROMOTED_TILES and dtype == torch.float32:
            continue
        tiles = -(-m // bm) * -(-n // bn)
        for split in range(1, 2 if tile in UNSPLIT_TILES else MAX_SPLIT + 1):
            if split > 1 and slices // split < MIN_SPLIT_SLICES:
                break
            per_block = -(-slices // split) + _FIXED_SLICES + (_REDUCE_SLICES if split > 1 else 0.0)
            cost = -(-tiles * split // sms) * per_block * bm * bn / eff
            if best is None or cost < best[0]:
                best = (cost, GemmPlan(tile, bm, bn, split, tiles * split, slices, cin))
    return best[1]


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """``conv_window``'s tiling of one layer: tiles of ``tr`` output rows by
    ``tw`` columns of one image, each read from a window of ``wr`` input
    rows by ``wcc`` elements (``((tw - 1) * stride + ks) * cin``), rows
    ``wp`` elements apart in shared memory."""
    tr: int
    tw: int
    tiles_h: int   # tiles of an image along its rows
    tiles_w: int   # and along its columns
    tiles: int     # batch * tiles_h * tiles_w
    wr: int
    wcc: int
    wp: int
    slices: int    # K slices, all resident in shared memory
    smem: int      # bytes of shared memory a block takes

    def describe(self) -> str:
        return (f"conv_window: {self.tr}x{self.tw} pixel tiles, {self.tiles} tiles, window "
                f"{self.wr}x{self.wcc} elements, {self.slices} resident slices, {self.smem} B shared")


def window_pitch(wcc: int, dtype: torch.dtype) -> int:
    """Elements from one window row to the next (``csrc/fused_encoder.cu::
    window_pitch``): a row is fetched in copies of up to 16 bytes from the
    aligned element at or below its first, so it keeps up to a copy's
    elements less one more, in whole copies."""
    e = 16 // (4 if dtype == torch.float32 else 2)
    return (wcc + 2 * e - 2) // e * e


def window_smem(tr: int, tw: int, ks: int, stride: int, cin: int, dtype: torch.dtype) -> int:
    """Shared memory of a ``conv_window`` block (``csrc/fused_encoder.cu::
    window_smem``): alignment slack, the resident packed weights (hi and lo
    for float32) of 64 channels, the windows, the epilogue's staging, the
    bias, the pixel slots' places and the tap-offset table."""
    kp = padded_depth(ks * ks * cin, dtype)
    esize = 4 if dtype == torch.float32 else 2
    wp = window_pitch(((tw - 1) * stride + ks) * cin, dtype)
    win = ((tr - 1) * stride + ks) * wp * esize
    parts = 2 if dtype == torch.float32 else 1
    return (1024 + (kp // slice_depth(dtype)) * parts * 64 * 128 + WINDOW_BUFFERS * (-(-win // 16) * 16)
            + WINDOW_STAGING + (64 + WINDOW_SLOTS) * 4 + kp * 4)


@functools.lru_cache(maxsize=None)
def fit_window(batch: int, h: int, w: int, cin: int, ks: int, stride: int, pad: int,
               dtype: torch.dtype) -> Optional[WindowPlan]:
    """The tiling of a ``conv_window`` layer (a layer whose ``cin`` is no
    multiple of the slice depth), or None where no block fits shared
    memory. A tile is ``tw`` columns (``ceil(ow / c)`` for ``c`` tiles a
    row) by as many rows as fill its 128 pixel slots; the plan takes the
    fewest pixel slots in all, then the smallest window, among the tilings
    whose block fits shared memory: where a wide window would not fit, the
    width is cut, never the result."""
    oh, ow = (h + 2 * pad - ks) // stride + 1, (w + 2 * pad - ks) // stride + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output of a {ks}x{ks} conv on {h}x{w}")
    slices = padded_depth(ks * ks * cin, dtype) // slice_depth(dtype)
    best = None
    for cols in range(1, ow + 1):
        tw = -(-ow // cols)
        if tw > WINDOW_SLOTS or (cols > 1 and tw == -(-ow // (cols - 1))):
            continue
        tr = min(oh, WINDOW_SLOTS // tw)
        wr, wcc = (tr - 1) * stride + ks, ((tw - 1) * stride + ks) * cin
        smem = window_smem(tr, tw, ks, stride, cin, dtype)
        if smem > WINDOW_SMEM:
            continue
        tiles_h, tiles_w = -(-oh // tr), -(-ow // tw)
        key = (tiles_h * tiles_w, wr * wcc)
        if best is None or key < best[0]:
            best = (key, WindowPlan(tr, tw, tiles_h, tiles_w, batch * tiles_h * tiles_w, wr, wcc,
                                    window_pitch(wcc, dtype), slices, smem))
    return None if best is None else best[1]


def plan_window(batch: int, h: int, w: int, cin: int, ks: int, stride: int, pad: int,
                dtype: torch.dtype) -> WindowPlan:
    """:func:`fit_window`'s tiling; raises where no block fits (a trunk
    pads such a layer's channels for ``conv_wgmma`` instead)."""
    plan = fit_window(batch, h, w, cin, ks, stride, pad, dtype)
    if plan is None:
        slices = padded_depth(ks * ks * cin, dtype) // slice_depth(dtype)
        raise ValueError(
            f"no conv_window tiling for a {ks}x{ks} conv of {cin} channels ({dtype}): its "
            f"{slices} packed weight slices and a window exceed {WINDOW_SMEM} bytes of shared memory")
    return plan


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """``dense_tma``'s grid: ``n_tiles`` blocks of 64 w rows by ``m_tiles``
    of ``nx`` x rows by ``split`` K ranges of ``per`` slices (a cluster)."""
    nx: int
    split: int
    n_tiles: int
    m_tiles: int
    slices: int
    per: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.split

    def slice_ranges(self):
        """The K slices of each block along the split, as the kernel takes them."""
        return [(z * self.per, min(self.slices, (z + 1) * self.per)) for z in range(self.split)]

    def describe(self) -> str:
        return (f"dense_tma: {DENSE_WROWS} w rows x {self.nx} x rows a block, split {self.split}, "
                f"{self.blocks} blocks, {self.slices} slices ({self.per} a block)")


def dense_rows(m: int) -> int:
    """x rows a ``dense_tma`` block holds: the fewest of ``DENSE_NX`` that
    cover ``min(m, 128)``."""
    return next(v for v in DENSE_NX if v >= min(m, DENSE_NX[-1]))


@functools.lru_cache(maxsize=None)
def plan_dense(m: int, n: int, k: int, dtype: torch.dtype, clusters: Tuple[int, ...]) -> DensePlan:
    """The grid of ``lrelu(x (m, k) @ w (n, k)^T + b)``: ``dense_rows(m)`` x
    rows a block, then the K split (a cluster of up to 8 blocks) that puts
    the most blocks on the card in one wave, no block with fewer than two
    slices (one for each consumer warpgroup) or with none. ``clusters[s -
    1]``: how many clusters of ``s`` blocks the card runs at once, as the
    kernel counts them (a GPC holds whole clusters, so an H100 runs 15
    clusters of 8, not 16)."""
    slices = -(-k // slice_depth(dtype))
    nx = dense_rows(m)
    m_tiles, n_tiles = -(-m // nx), -(-n // DENSE_WROWS)
    tiles = m_tiles * n_tiles
    best = 1
    for split in range(2, min(MAX_SPLIT, max(1, slices // 2)) + 1):
        if clusters[split - 1] >= tiles:
            best = split
    per = -(-slices // best)
    return DensePlan(nx, -(-slices // per), n_tiles, m_tiles, slices, per)


@torch.no_grad()
def pack_dense(w: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` -> a new ``(N, Kp)`` copy, zero beyond K and 16-byte
    aligned, in its own type (float32 is split into TF32 parts inside the
    kernel): ``dense_tma``'s A operand where ``w`` itself is not one (a
    ragged K, or a view off the alignment)."""
    n, k = w.shape
    out = w.new_zeros((n, padded_depth(k, w.dtype)))
    out[:, :k] = w
    return out


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
