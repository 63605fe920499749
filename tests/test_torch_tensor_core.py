"""What the tensor-core redesign keeps in Python, checked without a card:
the packed weight layout, the TF32 hi/lo split and why three products are
needed, the per-tensor cache, and the launch plan at both paths' full shapes.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagecfgen_torch.models.bigan import audio_mnist_bigan_config, mnist_bigan_config
from imagecfgen_torch.ops import tensor_core as tc
from imagecfgen_torch.ops.fused_encoder import (
    fused_encoder_reference,
    plan_conv_ops,
    trunk_launch_plan,
)

F32, BF16 = torch.float32, torch.bfloat16
SMS = 132  # an H100 SXM


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32))


# ------------------------------------------------------------ packed layout


@pytest.mark.parametrize("cin,k,stride,pad", [(5, 3, 2, 1), (64, 4, 2, 1), (7, 5, 2, 1), (32, 1, 2, 0)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_packed_weights_give_the_unfold_product(cin, k, stride, pad, dtype):
    """Rows of NHWC patches (input channel fastest) times the packed
    weights equal the plain version's ``F.unfold`` product."""
    x = _rand((2, 9, 9, cin), 0).to(dtype)
    w = _rand((6, cin, k, k), 1, 0.2).to(dtype)
    b = _rand((6,), 2, 0.1).to(dtype)
    packed = tc.pack_conv_weight(w)
    kp = tc.padded_depth(k * k * cin, dtype)
    assert all(p.shape == (6, kp) and p.is_contiguous() and p.dtype == dtype for p in packed)
    assert len(packed) == (2 if dtype == F32 else 1)
    full = (packed[0] + packed[1]) if dtype == F32 else packed[0]
    if kp > k * k * cin:
        assert float(full[:, k * k * cin:].abs().max()) == 0.0
    # im2col in the kernel's order: (kh, kw, ci), ci fastest
    xp = F.pad(x.float().permute(0, 3, 1, 2), (pad, pad, pad, pad)).permute(0, 2, 3, 1)
    oh = (9 + 2 * pad - k) // stride + 1
    rows = torch.stack([
        xp[:, i * stride:i * stride + k, j * stride:j * stride + k, :].reshape(2, -1)
        for i in range(oh) for j in range(oh)], dim=1).reshape(2 * oh * oh, -1)
    out = rows @ full.float()[:, :k * k * cin].t() + b.float()
    ref = fused_encoder_reference(x.float(), [(w.float(), b.float())], ((stride, pad, None),))
    torch.testing.assert_close(out.reshape(2, -1), ref, rtol=1e-5, atol=1e-5)


def test_pack_rows_pads_a_ragged_depth():
    w = _rand((5, 301), 3)
    hi, lo = tc.pack_rows(w)
    assert hi.shape == lo.shape == (5, 320)
    torch.testing.assert_close((hi + lo)[:, :301], w, rtol=2.0 ** -21, atol=0)
    assert float(hi[:, 301:].abs().max()) == float(lo[:, 301:].abs().max()) == 0.0
    (wb,) = tc.pack_rows(w.to(BF16))
    assert wb.shape == (5, 320) and torch.equal(wb[:, :301], w.to(BF16))
    aligned = _rand((5, 128), 4).to(BF16)
    assert tc.pack_rows(aligned)[0].data_ptr() == aligned.data_ptr()  # stored as the kernel reads it


def test_slice_depth_rejects_other_types():
    assert tc.slice_depth(F32) == 32 and tc.slice_depth(BF16) == 64
    with pytest.raises(ValueError):
        tc.slice_depth(torch.float16)


# ------------------------------------------------------------- hi/lo split


def test_hi_has_tf32_mantissa_and_hi_plus_lo_is_w():
    w = torch.cat([_rand((4096,), 5), _rand((4096,), 6, 1e-3), -_rand((4096,), 7, 50.0).abs()])
    hi, lo = tc.split_tf32(w)
    for part in (hi, lo):  # 10 mantissa bits: the low 13 of float32's 23 are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - w).abs() / w.abs()).max()) <= 2.0 ** -11  # round to nearest
    assert float(((hi + lo - w).abs() / w.abs()).max()) <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tc.tf32_round(tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


def test_three_tf32_products_hold_the_gate_where_one_misses_it():
    """An emulation of the kernel's sum at the deepest reduction of the
    paths (K = 25,600, audio layer 6): products of TF32 operands are exact
    in float32 and are summed here in float64, so what is measured is the
    operand rounding alone. 3xTF32 stays inside the gate
    1e-4 * max(1, max|plain|); single-pass TF32 does not."""
    k = 25600
    a = _rand((64, k), 8)
    b = _rand((48, k), 9, k ** -0.5)  # outputs of order 1, as a trained layer's
    exact = a.double() @ b.double().t()
    gate = 1e-4 * max(1.0, float(exact.abs().max()))
    a_hi, a_lo = (t.double() for t in tc.split_tf32(a))
    b_hi, b_lo = (t.double() for t in tc.split_tf32(b))
    three = a_lo @ b_hi.t() + a_hi @ b_lo.t() + a_hi @ b_hi.t()
    one = a_hi @ b_hi.t()
    assert float((three - exact).abs().max()) <= 0.01 * gate
    assert float((one - exact).abs().max()) > gate


# ------------------------------------------------------------------- cache


def test_cache_follows_in_place_updates_and_load_state_dict():
    calls = []

    def make(t):
        calls.append(1)
        return tc.pack_conv_weight(t)

    conv = torch.nn.Conv2d(4, 3, 3)
    w = conv.weight
    with torch.no_grad():
        first = tc.cached(w, "packed", make)
        assert tc.cached(w, "packed", make) is first and len(calls) == 1
        w.mul_(2.0)  # an optimizer step
        second = tc.cached(w, "packed", make)
        assert second is not first and len(calls) == 2
        assert all(torch.equal(a, b) for a, b in zip(second, tc.pack_conv_weight(w)))
        conv.load_state_dict({"weight": torch.ones_like(w), "bias": torch.zeros(3)})
        third = tc.cached(conv.weight, "packed", make)
        assert len(calls) == 3 and float((third[0] + third[1])[:, :36].min()) == 1.0
        w.data = torch.zeros_like(w)  # new storage
        assert float(tc.cached(w, "packed", make)[0].abs().max()) == 0.0 and len(calls) == 4
        assert tc.cached(w, "other tag", make) is not None and len(calls) == 5


def test_cache_drops_entries_of_freed_tensors():
    before = len(tc._CACHE)
    t = torch.ones(4, 4)
    tc.cached(t, "x", lambda v: v + 1)
    assert len(tc._CACHE) == before + 1
    del t
    assert len(tc._CACHE) == before


def test_cast_cached_keeps_the_type_it_has():
    t = torch.ones(3)
    assert tc.cast_cached(t, F32) is t
    with torch.no_grad():
        assert tc.cast_cached(t, BF16) is tc.cast_cached(t, BF16)


# ------------------------------------------------------------- launch plan


def _trunk_shapes(cfg, cin):
    shapes = []
    for op in cfg.enc_plan:
        if op[0] == "conv":
            shapes.append((op[1], cin, op[2], op[2]))
            cin = op[1]
    return shapes


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", ["mnist", "audio"])
def test_every_layer_of_both_trunks_fills_the_card(path, dtype):
    """At the paths' full shapes every layer has blocks for at least 90 % of
    the SMs, or splits K over a cluster; only the first layer (5 or 7
    channels) takes the scalar gather."""
    cfg, in_shape = ((mnist_bigan_config(), (2048, 28, 28, 5)) if path == "mnist"
                     else (audio_mnist_bigan_config(), (128, 128, 128, 7)))
    plans = trunk_launch_plan(in_shape, _trunk_shapes(cfg, in_shape[-1]),
                              plan_conv_ops(cfg.enc_plan), dtype, SMS)
    assert len(plans) == len(plan_conv_ops(cfg.enc_plan))
    for i, p in enumerate(plans):
        assert p.blocks >= 0.9 * SMS or p.split > 1, (i, p)
        assert 1 <= p.split <= tc.MAX_SPLIT
        assert p.split == 1 or p.slices // p.split >= tc.MIN_SPLIT_SLICES
        assert p.vec == (i > 0)
        assert (p.bm, p.bn) == tc.TILES[p.tile][:2]
    if path == "audio":  # the layers the CUDA-core kernel starved: 16 and 144 blocks, no split
        assert plans[5].split == tc.MAX_SPLIT and plans[5].blocks >= 128
        assert plans[4].split > 1 and plans[4].blocks >= 2 * SMS


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_dense_head_splits_over_one_cluster(dtype):
    p = tc.plan_gemm(128, 1024, 4096, 4096, dtype, SMS)
    assert (p.bm, p.bn, p.split, p.blocks, p.vec) == (128, 64, 8, 128, True)


@pytest.mark.parametrize("shape", [(100, 200, 300), (100, 200, 3000), (100, 200, 301), (1, 1, 1),
                                   (37 * 196, 64, 45), (5, 512, 25600)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_ragged_shapes_get_a_plan(shape, dtype):
    m, n, k = shape
    p = tc.plan_gemm(m, n, k, k, dtype, SMS)
    assert p.blocks == -(-m // p.bm) * -(-n // p.bn) * p.split
    assert p.slices == -(-k // tc.slice_depth(dtype))
    assert p.vec == (k % tc.slice_depth(dtype) == 0)
    assert 1 <= p.split <= min(tc.MAX_SPLIT, max(1, p.slices // tc.MIN_SPLIT_SLICES))


def test_plan_adapts_to_the_sm_count():
    few = tc.plan_gemm(2048, 512, 4096, 256, F32, 16)
    many = tc.plan_gemm(2048, 512, 4096, 256, F32, SMS)
    assert few.split == 1 and many.split > 1
