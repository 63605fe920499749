"""The port's fused-encoder module against the JAX package's.

Same inputs (numpy, from a seed) go through ``imagecfgen_tpu`` and
``imagecfgen_torch``. Tolerance for the conv stack: 2e-4 absolute, as in
``tests/test_pallas_ops.py`` — both sides sum f32 products of a five-layer
stack in different orders.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.ops.pallas import fused_encoder as jfe
from imagecfgen_torch.core.convert import plan_state_dict_from_jax
from imagecfgen_torch.ops import fused_encoder as tfe

ATOL = 2e-4


def _trunk(seed=0, latent=512):
    """Full-width MNIST encoder trunk, weights N(0, 0.05) as in
    ``tests/test_pallas_ops.py``: JAX (HWIO) and port (PyTorch layout)."""
    plan = jbigan.mnist_bigan_config(latent_dim=latent).enc_plan
    rng = np.random.default_rng(seed)
    c_in, params, i = 5, {}, 0
    for op in plan:
        if op[0] != "conv":
            continue
        ch, k = op[1], op[2]
        params[f"conv_{i}_kernel"] = rng.normal(0, 0.05, (k, k, c_in, ch)).astype(np.float32)
        params[f"conv_{i}_bias"] = rng.normal(0, 0.05, ch).astype(np.float32)
        c_in, i = ch, i + 1
    return plan, params, plan_state_dict_from_jax(params)


def _feats(b, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (b, 28, 28, 5)).astype(np.float32)


def _jax_pairs(params, n):
    return [(jnp.asarray(params[f"conv_{j}_kernel"]), jnp.asarray(params[f"conv_{j}_bias"]))
            for j in range(n)]


def _torch_pairs(tparams, n):
    return [(tparams[f"conv_{j}_kernel"], tparams[f"conv_{j}_bias"]) for j in range(n)]


@pytest.mark.parametrize("config", ["mnist", "mnist64", "audio", "whale", "esrf"])
def test_plan_conv_ops_matches_jax(config):
    cfg = {
        "mnist": jbigan.mnist_bigan_config,
        "mnist64": lambda: jbigan.mnist_bigan_config(latent_dim=64),
        "audio": jbigan.audio_mnist_bigan_config,
        "whale": jbigan.whale_bigan_config,
        "esrf": jbigan.esrf_bigan_config,
    }[config]()
    assert tfe.plan_conv_ops(cfg.enc_plan) == jfe.plan_conv_ops(cfg.enc_plan)


@pytest.mark.parametrize("plan", [
    (("bn",),),
    (("lrelu", 0.2), ("conv", 8, 3, 1, 0)),
    (("conv", 8, 3, 1, 0), ("tanh",)),
])
def test_plan_conv_ops_rejects_like_jax(plan):
    with pytest.raises(ValueError):
        jfe.plan_conv_ops(plan)
    with pytest.raises(ValueError):
        tfe.plan_conv_ops(plan)


def test_trunk_weights_matches_jax():
    _, params, tparams = _trunk()
    j = jfe.trunk_weights(params)
    t = tfe.trunk_weights(tparams)
    assert len(t) == len(j) == 10
    for jw, tw in zip(j, t):
        assert tuple(tw.shape) == (jw.shape if jw.ndim == 1 else
                                   (jw.shape[3], jw.shape[2], jw.shape[0], jw.shape[1]))


@pytest.mark.parametrize("b", [32, 5])
def test_reference_matches_xla(b):
    """The plain version equals the JAX package's XLA trunk, also for a
    batch that no tile divides."""
    plan, params, tparams = _trunk()
    ops = tfe.plan_conv_ops(plan)
    feats = _feats(b)
    ref = jfe._xla_reference(jnp.asarray(feats), _jax_pairs(params, len(ops)), ops)
    out = tfe.fused_encoder_reference(torch.from_numpy(feats), _torch_pairs(tparams, len(ops)), ops)
    assert out.shape == ref.shape == (b, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [0, 2])
def test_reference_matches_pallas_interpret(split):
    """The plain version equals the Pallas kernel run in interpret mode,
    fully fused and with the first convs split off."""
    plan, params, tparams = _trunk(latent=64)
    ops = tfe.plan_conv_ops(plan)
    feats = _feats(8, seed=3)
    pallas = jfe.fused_encoder_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats), plan,
        batch_tile=4, split=split, interpret=True,
    )
    out = tfe.fused_encoder_reference(torch.from_numpy(feats), _torch_pairs(tparams, len(ops)), ops)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [0, 2])
def test_wrapper_takes_plain_version_on_cpu(split):
    plan, params, tparams = _trunk(latent=64)
    ops = tfe.plan_conv_ops(plan)
    feats = torch.from_numpy(_feats(3, seed=4))
    before = tfe.fused_encoder_forward.launches
    out = tfe.fused_encoder_forward(tparams, feats, plan, split=split)
    assert tfe.fused_encoder_forward.launches == before
    ref = tfe.fused_encoder_reference(feats, _torch_pairs(tparams, len(ops)), ops)
    assert torch.equal(out, ref)


def test_wrapper_checks_its_inputs():
    plan, _, tparams = _trunk(latent=64)
    with pytest.raises(ValueError):
        tfe.fused_encoder_forward(tparams, torch.zeros(28, 28, 5), plan)
    del tparams["conv_4_kernel"], tparams["conv_4_bias"]
    with pytest.raises(ValueError):
        tfe.fused_encoder_forward(tparams, torch.zeros(1, 28, 28, 5), plan)


def test_cuda_source_names_the_kernel_it_replaces():
    src = Path(tfe.__file__).resolve().parents[1] / "csrc" / "fused_encoder.cu"
    text = src.read_text()
    assert "imagecfgen_tpu/ops/pallas/fused_encoder.py" in text
    assert "_pallas_encoder" in text
    assert 'extern "C" int fused_encoder_run' in text
    for banned in ("cudnn", "cublas", "torch/extension.h"):
        assert banned not in text.lower()


def test_every_layers_output_is_held_under_2_to_the_31():
    """The launch recipe refuses a layer whose output reaches 2^31 elements
    (the kernel indexes in 32 bits) even when the features stay under it:
    here 8192^2 inputs of one channel, 64 channels out."""
    plan = (("conv", 64, 1, 1, 0),)
    conv_ops = tfe.plan_conv_ops(plan)
    with pytest.raises(ValueError, match=r"layer 0: an output of 2\^31 elements or more"):
        tfe._recipe((1, 8192, 8192, 1), ((64, 1, 1, 1),), conv_ops, 0, torch.float32, 132)
    # 31 channels out stay under it
    tfe._recipe((1, 8192, 8192, 1), ((31, 1, 1, 1),), conv_ops, 0, torch.float32, 132)
    # the ESRF trunk at its training batch: every layer under 2^31
    from imagecfgen_torch.models.bigan import esrf_bigan_config

    eplan = esrf_bigan_config().enc_plan
    shapes, c = [], 3
    for op in eplan:
        if op[0] == "conv":
            shapes.append((op[1], c, op[2], op[2]))
            c = op[1]
    out = tfe._recipe((16, 512, 512, 3), tuple(shapes), tfe.plan_conv_ops(eplan), 0, torch.float32, 132)[2]
    assert out[0] == (16, 255, 255, 64) and out[-1] == (16, 1, 1, 512)


# ------------------------------------------------- the first layer's tiling

from imagecfgen_torch.ops import tensor_core as tc  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,ks", [
    ((2048, 28, 28, 5), 3), ((1, 28, 28, 5), 3),             # MNIST: the engine, an explainer
    ((128, 128, 128, 7), 5), ((12, 128, 128, 7), 5),         # audio: a score, cf-eval's last chunk
    ((32, 256, 256, 2), 5), ((7, 256, 256, 2), 5),           # whale: a batch, whale_cf_score's last
    ((16, 512, 512, 3), 5), ((14, 512, 512, 3), 5)])         # ESRF: training, esrf_quality
def test_first_layer_tiling_covers_every_pixel_once(shape, ks, dtype):
    """``conv_window``'s tiles, decoded as the kernel decodes them, hold
    every output pixel of the layer exactly once, a ragged last batch
    included; a tile fits its 128 slots and its block (resident weights,
    three windows of the rows and elements the tile's pixels read) fits
    shared memory."""
    b, h, w, c = shape
    stride, pad = 2, 1
    plan = tc.plan_window(b, h, w, c, ks, stride, pad, dtype)
    oh, ow = (h + 2 * pad - ks) // stride + 1, (w + 2 * pad - ks) // stride + 1
    assert plan.tr * plan.tw <= tc.WINDOW_SLOTS and plan.tiles == b * plan.tiles_h * plan.tiles_w
    assert plan.smem == tc.window_smem(plan.tr, plan.tw, ks, stride, c, dtype) <= tc.WINDOW_SMEM
    assert plan.wr == (plan.tr - 1) * stride + ks and plan.wcc == ((plan.tw - 1) * stride + ks) * c
    # rows are fetched in 16-byte copies from an aligned element: a row keeps a copy more
    e = 4 if dtype == torch.float32 else 8
    assert plan.wp % e == 0 and plan.wcc + e - 1 <= plan.wp < plan.wcc + 2 * e - 1
    seen = np.zeros((b, oh, ow), np.int64)
    for t in range(plan.tiles):  # decoded as the kernel decodes a tile's place
        img, r = divmod(t, plan.tiles_h * plan.tiles_w)
        th, tcol = divmod(r, plan.tiles_w)
        rows = np.arange(th * plan.tr, min(oh, (th + 1) * plan.tr))
        cols = np.arange(tcol * plan.tw, min(ow, (tcol + 1) * plan.tw))
        seen[img, rows[:, None], cols[None, :]] += 1
    assert int(seen.min()) == int(seen.max()) == 1
    # the slots waste little: at most one tile row and column of every image
    assert plan.tiles * tc.WINDOW_SLOTS <= b * (oh + plan.tr) * (ow + plan.tw) * tc.WINDOW_SLOTS / (plan.tr * plan.tw)


def test_first_layer_takes_the_window_kernel_and_the_rest_conv_wgmma():
    """The launch recipe hands the first layer's tile to ``conv_window``
    (path 0: its output rows and columns) and every later layer's tile and
    split to ``conv_wgmma`` (path 1)."""
    cfg = jbigan.audio_mnist_bigan_config()
    shapes, c = [], 7
    for op in cfg.enc_plan:
        if op[0] == "conv":
            shapes.append((op[1], c, op[2], op[2]))
            c = op[1]
    conv_ops = tfe.plan_conv_ops(cfg.enc_plan)
    ints = list(tfe._recipe((128, 128, 128, 7), tuple(shapes), conv_ops, 0, torch.float32, 132)[0])
    rows = [ints[9 * i:9 * i + 9] for i in range(len(conv_ops))]
    first = tc.plan_window(128, 128, 128, 7, 5, 2, 1, torch.float32)
    assert rows[0][5:] == [192, first.tr, first.tw, 0]
    assert all(r[8] == 1 for r in rows[1:])
    plans = tfe.trunk_launch_plan((128, 128, 128, 7), shapes, conv_ops, torch.float32, 132)
    assert [r[6:8] for r in rows[1:]] == [[p.tile, p.split] for p in plans[1:]]


def _window_a_rows(x, plan, tile, ks, stride, pad, esize):
    """The A rows (pixel slot x tap) ``conv_window`` builds for ``tile``, by
    the kernel's arithmetic: the window fetched in the widest copies (16, 8
    or 4 bytes) that no row edge splits, from the aligned element at or
    below the window's first (its shift), rows ``wp`` elements apart, then
    each slot's base plus each tap's offset."""
    bsz, h, w, c = x.shape
    rowlen = w * c
    row_bytes = rowlen * esize
    copy = 16 if row_bytes % 16 == 0 else 8 if row_bytes % 8 == 0 else 4
    e_ = copy // esize
    by_copies = row_bytes % 4 == 0
    b, r = divmod(tile, plan.tiles_h * plan.tiles_w)
    th, tc_ = divmod(r, plan.tiles_w)
    ih0, f0 = th * plan.tr * stride - pad, (tc_ * plan.tw * stride - pad) * c
    sh = f0 - (f0 // e_) * e_ if by_copies else 0
    flat = x.reshape(bsz, h, rowlen)
    buf = np.zeros((plan.wr, plan.wp), x.dtype)
    for rr in range(plan.wr):
        ih = ih0 + rr
        if not 0 <= ih < h:
            continue
        if by_copies:
            for u in range(plan.wp // e_):
                f = f0 - sh + u * e_
                if 0 <= f < rowlen:
                    buf[rr, u * e_:(u + 1) * e_] = flat[b, ih, f:f + e_]
        else:
            for cc in range(plan.wcc):
                if 0 <= f0 + cc < rowlen:
                    buf[rr, cc] = flat[b, ih, f0 + cc]
    taps = [(kh, kw, ci) for kh in range(ks) for kw in range(ks) for ci in range(c)]
    koff = np.array([kh * plan.wp + kw * c + ci for kh, kw, ci in taps])
    rows = {}
    for slot in range(plan.tr * plan.tw):
        pr, pc = divmod(slot, plan.tw)
        base = pr * stride * plan.wp + pc * stride * c + sh
        rows[(b, th * plan.tr + pr, tc_ * plan.tw + pc)] = buf.reshape(-1)[base + koff]
    return rows


@pytest.mark.parametrize("shape,ks,esize", [
    ((1, 28, 28, 5), 3, 4), ((1, 28, 28, 5), 3, 2), ((1, 128, 128, 7), 5, 4), ((1, 128, 128, 7), 5, 2),
    ((1, 256, 256, 2), 5, 4), ((1, 512, 512, 3), 5, 2), ((1, 29, 29, 5), 3, 2), ((2, 9, 7, 1), 1, 2)])
def test_window_addressing_reproduces_im2col(shape, ks, esize):
    """The kernel's window arithmetic (copies, shift, pitch, tap offsets)
    gives every pixel of a tile its im2col row, padding zeros included, for
    the trunks' first layers in both element sizes, an odd bf16 row (copied
    element by element) and a 1x1 conv; first, middle and last tiles."""
    stride, pad = (2, 1) if ks > 1 else (1, 0)
    x = np.random.default_rng(21).normal(0, 1, shape).astype(np.float32)
    dtype = torch.float32 if esize == 4 else torch.bfloat16
    plan = tc.plan_window(*shape, ks, stride, pad, dtype)
    oh, ow = (shape[1] + 2 * pad - ks) // stride + 1, (shape[2] + 2 * pad - ks) // stride + 1
    cols = torch.nn.functional.unfold(torch.from_numpy(x).permute(0, 3, 1, 2), ks, padding=pad, stride=stride)
    # unfold orders a column (ci, kh, kw); the kernel's taps are (kh, kw, ci)
    cols = cols.reshape(shape[0], shape[3], ks, ks, oh * ow).permute(0, 4, 2, 3, 1).reshape(shape[0], oh * ow, -1)
    for tile in sorted({0, 1, plan.tiles // 2, plan.tiles - 1}):
        for (b, i, j), row in _window_a_rows(x, plan, tile, ks, stride, pad, esize).items():
            if i < oh and j < ow:
                np.testing.assert_array_equal(row, cols[b, i * ow + j].numpy())


@pytest.mark.parametrize("d,dtype", [(16, torch.float32), (48, torch.float32), (48, torch.bfloat16)],
                         ids=["d16-f32", "d48-f32", "d48-bf16"])
@pytest.mark.parametrize("split", [0, 1])
def test_padded_channels_give_the_narrow_trunk(d, dtype, split):
    """A narrow trunk (``--d``) whose later layers' weights do not fit
    ``conv_window``: the launch recipe pads their input channels to the
    slice depth, the layer before writes the padded channels from zero
    weights and bias, and a trunk's input is copied with zero channels.
    Computed so, the padded channels stay zero and the trunk equals its
    plain version; the recipe runs those layers on ``conv_wgmma``."""
    from imagecfgen_torch.models.bigan import audio_mnist_bigan_config

    plan = audio_mnist_bigan_config(d=d).enc_plan[:8]  # four convs, for a 40 x 40 input
    conv_ops = tfe.plan_conv_ops(plan)
    rng = np.random.default_rng(31)
    pairs, c = [], 7
    for stride, pad, _ in conv_ops:
        co = [op for op in plan if op[0] == "conv"][len(pairs)][1]
        pairs.append((torch.from_numpy(rng.normal(0, 1 / np.sqrt(25 * c), (co, c, 5, 5)).astype(np.float32)).to(dtype),
                      torch.from_numpy(rng.normal(0, 0.05, co).astype(np.float32)).to(dtype)))
        c = co
    x = torch.from_numpy(rng.normal(0, 1, (2, 40, 40, 7)).astype(np.float32)).to(dtype)
    want = tfe._plain_layers(x, pairs, conv_ops)
    feats = tfe._plain_layers(x, pairs[:split], conv_ops[:split]) if split else x
    ints, _, out_shapes, channels = tfe._recipe(
        tuple(feats.shape), tuple(tuple(w.shape) for w, _ in pairs), conv_ops, split, dtype, 132)
    rows = [list(ints[9 * i:9 * i + 9]) for i in range(len(conv_ops))]
    padded = [i for i in range(split, len(pairs)) if channels[i] != tuple(pairs[i][0].shape[:2])]
    assert padded and all(rows[i][8] == 1 for i in padded if channels[i][1] != pairs[i][0].shape[1])
    got = torch.nn.functional.pad(feats, (0, channels[split][1] - feats.shape[3]))
    for i in range(split, len(pairs)):
        co, ci = channels[i]
        w, b = pairs[i]
        assert rows[i][3] == co and rows[i][5] == tc.padded_depth(25 * ci, dtype)
        assert ci % tc.slice_depth(dtype) == 0 or ci == w.shape[1]  # conv_window reads its own
        got = tfe._plain_layers(got, [(tfe.padded_kernel(w, co, ci), torch.nn.functional.pad(b, (0, co - b.shape[0])))],
                                conv_ops[i:i + 1])
        assert tuple(got.shape) == out_shapes[i]
        assert not bool(got[..., w.shape[0]:].any())
    tol = (2e-4 if dtype == torch.float32 else 2.0 ** -6) * max(1.0, float(want.float().abs().max()))
    assert got.shape == want.shape and float((got.float() - want.float()).abs().max()) <= tol
