"""The port's fused dense + LeakyReLU against the JAX package's.

Same inputs (numpy, from a seed) go through ``imagecfgen_tpu`` and
``imagecfgen_torch``; the JAX kernel runs in Pallas interpret mode (aligned
shapes) or through its XLA path (unaligned shapes), as
``tests/test_pallas_ops.py`` runs it. Tolerance 1e-5 absolute and relative:
both sides sum at most 2048 f32 products in different orders, with outputs
of order 1.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.ops.pallas.fused_dense import fused_dense_lrelu as j_fused
from imagecfgen_torch.ops import fused_dense as tfd

TOL = 1e-5


def _inputs(m, k, n, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)  # JAX layout (in, out)
    b = rng.normal(0, 0.5, n).astype(np.float32) if bias else np.zeros(n, np.float32)
    return x, w, b


def _port(x, w, b):
    """The same arrays in the port's layout: the dense kernel as (out, in)."""
    return torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(b)


@pytest.mark.parametrize("shape", [(128, 512, 512), (128, 2048, 512)], ids=["one_k_tile", "multi_k"])
def test_matches_jax_interpret(shape):
    x, w, b = _inputs(*shape, seed=0)
    ref = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 0.2, True)
    out = tfd.fused_dense_lrelu(*_port(x, w, b), 0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_unaligned_matches_jax_xla_path(slope):
    x, w, b = _inputs(100, 300, 200, seed=1)
    ref = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), slope)
    out = tfd.fused_dense_lrelu(*_port(x, w, b), slope)
    assert tuple(out.shape) == (100, 200)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_gradients_match_jax_custom_vjp():
    x, w, b = _inputs(128, 512, 512, seed=2)

    def loss(x, w, b):
        return (j_fused(x, w, b, 0.2, True) ** 2).mean()

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (t.requires_grad_() for t in _port(x, w, b))
    (tfd.fused_dense_lrelu(tx, tw, tb, 0.2) ** 2).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=1e-8)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw).T, rtol=TOL, atol=1e-8)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=TOL, atol=1e-8)


def test_gradients_match_autograd_of_plain_version():
    x, w, b = _inputs(16, 40, 24, seed=3)
    fused = [t.requires_grad_() for t in _port(x, w, b)]
    plain = [t.detach().clone().requires_grad_() for t in fused]
    (tfd.fused_dense_lrelu(*fused, 0.1).sin().sum()).backward()
    (tfd.fused_dense_reference(*plain, 0.1).sin().sum()).backward()
    for a, r in zip(fused, plain):
        torch.testing.assert_close(a.grad, r.grad, rtol=TOL, atol=1e-7)


def test_cpu_tensors_take_the_plain_version():
    x, w, b = _port(*_inputs(100, 300, 200, seed=4))
    before = tfd.fused_dense_lrelu.launches
    out = tfd.fused_dense_lrelu(x, w, b, 0.2)
    assert tfd.fused_dense_lrelu.launches == before
    assert torch.equal(out, tfd.fused_dense_reference(x, w, b, 0.2))


def test_other_devices_raise_rather_than_fall_back():
    x, w, b = (t.to("meta") for t in _port(*_inputs(4, 8, 6, seed=5)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfd.fused_dense_lrelu(x, w, b)


@pytest.mark.parametrize("bad", ["k", "bias", "rank", "device"])
def test_shape_and_device_checks(bad):
    x, w, b = _port(*_inputs(4, 8, 6, seed=6))
    if bad == "k":
        w = w[:, :7]
    elif bad == "bias":
        b = b[:5]
    elif bad == "rank":
        x = x.reshape(2, 2, 8)
    else:
        b = b.to("meta")
    with pytest.raises(ValueError, match="fused_dense_lrelu"):
        tfd.fused_dense_lrelu(x, w, b)


def test_cuda_source_names_the_kernel_it_replaces():
    src = Path(tfd.__file__).resolve().parents[1] / "csrc" / "fused_dense.cu"
    text = src.read_text()
    assert "_pallas_forward" in text and "_matmul_kernel" in text
    assert "sm_90a" in text
    assert "extern \"C\" int fused_dense_run" in text
    lowered = text.lower()
    assert not any(lib in lowered for lib in ("cublas", "cudnn", "#include <torch"))


# ------------------------------------------------------ the dense kernel's plan

from imagecfgen_torch.ops import tensor_core as tc  # noqa: E402

SMS = 132  # an H100 SXM


def h100_clusters(dtype, nx):
    """Clusters of 1-8 ``dense_tma`` blocks an H100 SXM runs at once, as
    ``fused_dense_clusters`` counted them on the card (float32 blocks of 16
    or 32 x rows fit two an SM)."""
    if dtype == torch.float32 and nx <= 32:
        return (264, 132, 79, 62, 47, 39, 32, 30)
    return (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("m", [1, 7, 16, 17, 32, 33, 64, 100, 128, 129, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_plan_owns_every_slice_once_and_fills_the_card(m, dtype):
    """At the heads' shape (M, 4096) x (1024, 4096): every K slice in exactly
    one block of the split, every block with at least one slice for each of
    its two consumer warpgroups, the grid in one wave of the clusters an
    H100 runs at once and on at least 70 % of its SMs (a GPC holds whole
    clusters), no larger split fitting, and the x rows a block holds the
    fewest that cover min(M, 128)."""
    caps = h100_clusters(dtype, tc.dense_rows(m))
    p = tc.plan_dense(m, 1024, 4096, dtype, caps)
    owned = [s for lo, hi in p.slice_ranges() for s in range(lo, hi)]
    assert owned == list(range(p.slices)) and p.slices == 4096 // tc.slice_depth(dtype)
    assert all(hi - lo >= 2 for lo, hi in p.slice_ranges())
    tiles = p.m_tiles * p.n_tiles
    assert tiles <= caps[p.split - 1] and all(caps[s - 1] < tiles for s in range(p.split + 1, tc.MAX_SPLIT + 1))
    assert 0.7 * SMS <= p.blocks <= 2 * SMS
    assert p.nx == min(v for v in tc.DENSE_NX if v >= min(m, 128)) and p.m_tiles * p.nx >= m


def _tf32_parts(a):
    hi, lo = tc.split_tf32(torch.from_numpy(a))
    return hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)


def test_dense_sum_order_holds_float64_at_k4096():
    """A numpy emulation of ``dense_tma``'s float32 sum at K = 4096 (the
    plan's K split, each block's slices alternating between its two
    warpgroups, a fresh tensor-core sum every 32-deep slice of three TF32
    products an 8-deep step, each instruction's dot exact and added in
    float32, the slices' sums added in float32, warpgroup 0's then 1's, the
    split's partial tiles in rank order, then the bias) stays within a
    quarter of the float32 gate of float64, as the trunks' sums do."""
    m, n, k = 8, 16, 4096
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.5, n).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64).T + b
    x_hi, x_lo = _tf32_parts(x)
    w_hi, w_lo = _tf32_parts(w)
    plan = tc.plan_dense(m, n, k, torch.float32, h100_clusters(torch.float32, tc.dense_rows(m)))
    total = np.zeros((m, n), np.float32)
    for lo_s, hi_s in plan.slice_ranges():
        wg_sums = [np.zeros((m, n), np.float32), np.zeros((m, n), np.float32)]
        for j, s in enumerate(range(lo_s, hi_s)):
            acc = np.zeros((m, n), np.float32)
            for ks in range(4):
                c = slice(s * 32 + ks * 8, s * 32 + ks * 8 + 8)
                for a, bb in ((w_lo, x_hi), (w_hi, x_lo), (w_hi, x_hi)):
                    acc = (acc + (bb[:, c] @ a[:, c].T).astype(np.float32)).astype(np.float32)
            wg_sums[j % 2] = (wg_sums[j % 2] + acc).astype(np.float32)
        total = (total + (wg_sums[0] + wg_sums[1]).astype(np.float32)).astype(np.float32)
    got = (total + b).astype(np.float64)
    gate = 1e-4 * max(1.0, float(np.abs(exact).max()))
    assert plan.split == 8 and float(np.abs(got - exact).max()) <= 0.25 * gate


def test_dense_plan_keeps_the_grid_in_one_wave_of_clusters():
    """Where the card runs fewer clusters of 8 than the head has column
    tiles (an H100: 15 of 8, 16 tiles), the plan takes the split that puts
    the most blocks on the card at once rather than a second wave."""
    caps = h100_clusters(torch.bfloat16, 128)
    p = tc.plan_dense(128, 1024, 4096, torch.bfloat16, caps)
    assert p.split == 6 and p.blocks == 96 and p.n_tiles <= caps[p.split - 1] < caps[p.split - 2]
    owned = [s for lo, hi in p.slice_ranges() for s in range(lo, hi)]
    assert owned == list(range(p.slices))
    roomy = (132, 66, 44, 33, 26, 22, 18, 16)  # a card with 16 clusters of 8: every cluster fits
    assert tc.plan_dense(128, 1024, 4096, torch.bfloat16, roomy).split == 8
    assert tc.plan_dense(256, 1024, 4096, torch.float32, caps).split == 3  # 32 tiles: 30 clusters of 4


def _records(monkeypatch):
    monkeypatch.setattr(tfd, "_clusters", lambda device, bf16, nx: h100_clusters(torch.float32, nx))
    return lambda t, m: tc.cached(t, f"dense_launch:{m}", lambda v: tfd._record(v, m))


def test_launch_record_is_cached_per_weight_and_rows(monkeypatch):
    """The launch record (the plan and the entry point's arguments) is made
    once per weight and row count and again after the weight changes in
    place; a ragged weight is read from one copy padded with zeros, which
    follows the weight's updates."""
    record = _records(monkeypatch)
    w = torch.from_numpy(np.random.default_rng(12).normal(0, 1, (8, 64)).astype(np.float32))
    rec = record(w, 5)
    assert rec[0] == tc.plan_dense(5, 8, 64, torch.float32, h100_clusters(torch.float32, 16))
    assert rec[1] == (0, 5, 8, 64, 64)
    assert record(w, 5) is rec and record(w, 7) is not rec
    with torch.no_grad():
        w.mul_(2)
    assert record(w, 5) is not rec
    ragged = torch.ones((8, 301), dtype=torch.bfloat16)
    _, args = record(ragged, 5)
    packed = tc.cached(ragged, "dense_padded", tc.pack_dense)
    assert args == (1, 5, 8, 301, 320)
    assert packed.shape == (8, 320) and float(packed[:, 301:].abs().max()) == 0.0
    assert tc.aligned16(packed) and packed.data_ptr() != ragged.data_ptr()
    with torch.no_grad():
        ragged.mul_(2)
    assert float(tc.cached(ragged, "dense_padded", tc.pack_dense)[:, :301].min()) == 2.0


def test_launch_record_lets_a_freed_weight_go(monkeypatch):
    """The cache keeps no weight alive: once a weight is freed, its launch
    records and its padded copy leave the cache with it."""
    import gc
    import weakref

    record = _records(monkeypatch)
    for k in (64, 301):
        w = torch.ones((8, k))
        alive = weakref.ref(w)
        record(w, 5)
        record(w, 32)
        tc.cached(w, "dense_padded", tc.pack_dense)
        slots = [(id(w), tag) for tag in ("dense_launch:5", "dense_launch:32", "dense_padded")]
        assert all(slot in tc._CACHE for slot in slots)
        del w
        gc.collect()
        assert alive() is None and not any(slot in tc._CACHE for slot in slots)
