"""The bf16 serving configuration (``compute_dtype=bfloat16``) of the port
against the JAX package's (``compute_dtype=jnp.bfloat16``).

Same float32 weights and inputs (numpy, from a seed) go through both; each
package casts them to bf16 for the forward. Tolerances are in bf16 ulps of
the largest reference output, ``ulps * 2**-8 * max|ref|`` (bf16 keeps 8 bits
of mantissa, so one ulp is at most ``2**-7`` relative and ``2**-8`` of the
top of its binade):

- a kernel's plain version against the Pallas kernel in interpret mode: ONE
  ulp. Both take the same bf16 values, accumulate in float32 and round once
  per layer; only the order of the float32 sum differs, which flips a
  rounding now and then.
- whole modules: a few ulps, stated at each test. The two packages round at
  other places: the JAX ``PlanSequential`` rounds a conv's output to bf16 and
  again after adding the bias, the fused paths (encoder trunk, dense +
  LeakyReLU) round once after bias and activation, and XLA's and PyTorch's
  CPU convs sum in other orders; every layer adds its own flipped roundings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.cf.engine import CounterfactualEngine as JEngine
from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_MNIST_SPEC
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.models import layers as jl
from imagecfgen_tpu.models.bigan import BiGAN as JBiGAN
from imagecfgen_tpu.models.bigan import audio_mnist_bigan_config as j_audio_cfg
from imagecfgen_tpu.models.bigan import mnist_bigan_config as j_cfg
from imagecfgen_tpu.ops.pallas import fused_encoder as jfe
from imagecfgen_tpu.ops.pallas.fused_dense import fused_dense_lrelu as j_fused_dense
from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeScaler
from imagecfgen_torch.core.convert import (
    bigan_params_from_jax,
    classifier_params_from_jax,
    plan_state_dict_from_jax,
    scm_from_jax_state_dict,
)
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import layers as tl
from imagecfgen_torch.models.bigan import audio_mnist_bigan_config, mnist_bigan_config
from imagecfgen_torch.ops import fused_dense as tfd
from imagecfgen_torch.ops import fused_encoder as tfe

BF16 = torch.bfloat16


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _ulps(ref, ulps):
    return ulps * 2.0 ** -8 * float(np.abs(ref).max())


def _close(out, ref, ulps):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = _np(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=_ulps(ref, ulps))


def _redraw(params, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = (1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name
               else 1.0 if "embed" in name else 0.1)
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def _mnist_attrs(b, rng, soft=False):
    digit = rng.dirichlet(np.ones(10), b) if soft else np.eye(10)[rng.integers(0, 10, b)]
    a = {"digit": digit.astype(np.float32)}
    for k in ("intensity", "slant", "thickness"):
        a[k] = rng.uniform(-1, 1, b).astype(np.float32)
    return a


# ------------------------------------------------ (a) the kernels' plain versions


@pytest.mark.parametrize("split,ulps", [(0, 1), (2, 3)])
def test_plain_encoder_matches_pallas_interpret_in_bf16(split, ulps):
    """Fully fused: one ulp. With the first two convs split off, the JAX
    side runs them in XLA, which rounds the conv and the bias sum apart:
    three ulps."""
    plan = j_cfg(latent_dim=64).enc_plan
    rng = np.random.default_rng(0)
    c_in, params, i = 5, {}, 0
    for op in plan:
        if op[0] == "conv":
            params[f"conv_{i}_kernel"] = rng.normal(0, 0.05, (op[2], op[2], c_in, op[1])).astype(np.float32)
            params[f"conv_{i}_bias"] = rng.normal(0, 0.05, op[1]).astype(np.float32)
            c_in, i = op[1], i + 1
    feats = rng.normal(0, 1, (16, 28, 28, 5)).astype(np.float32)
    ref = jfe.fused_encoder_forward(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        jnp.asarray(feats, jnp.bfloat16), plan, batch_tile=16, split=split, interpret=True)
    assert ref.dtype == jnp.bfloat16
    tparams = {k: v.to(BF16) for k, v in plan_state_dict_from_jax(params).items()}
    out = tfe.fused_encoder_forward(tparams, torch.from_numpy(feats).to(BF16), plan, split=split)
    assert out.dtype == BF16
    _close(out, ref, ulps=ulps)


@pytest.mark.parametrize("shape", [(128, 512, 512), (128, 2048, 512)], ids=["one_k_tile", "multi_k"])
def test_plain_dense_matches_pallas_interpret_in_bf16(shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.5, n).astype(np.float32)
    ref = j_fused_dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), 0.2, True)
    assert ref.dtype == jnp.bfloat16
    out = tfd.fused_dense_lrelu(torch.from_numpy(x).to(BF16),
                                torch.from_numpy(np.ascontiguousarray(w.T)).to(BF16),
                                torch.from_numpy(b).to(BF16), 0.2)
    assert out.dtype == BF16
    _close(out, ref, ulps=1)


def test_dense_gradients_match_jax_custom_vjp_in_bf16():
    """The backward's casts: float32 accumulation, gradients in the
    operands' types. Two ulps: the cotangent itself differs by a flipped
    rounding of the forward."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (128, 512)).astype(np.float32)
    w = (rng.normal(0, 1, (512, 512)) / np.sqrt(512)).astype(np.float32)
    b = rng.normal(0, 0.5, 512).astype(np.float32)
    g = rng.normal(0, 1, (128, 512)).astype(np.float32)

    def loss(x, w, b):
        return (j_fused_dense(x, w, b, 0.2, True).astype(jnp.float32) * g).sum()

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    tx, tw, tb = (t.to(BF16).requires_grad_() for t in (
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(b)))
    (tfd.fused_dense_lrelu(tx, tw, tb, 0.2).float() * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == tb.grad.dtype == BF16
    _close(tx.grad, gx, ulps=2)
    _close(tw.grad.t(), gw, ulps=2)
    _close(tb.grad, gb, ulps=2)


@pytest.mark.parametrize("bad", ["float16", "mixed_weights", "mixed_bias"])
def test_dense_wrapper_rejects_other_types(bad):
    x, w, b = torch.zeros(4, 8), torch.zeros(6, 8), torch.zeros(6)
    if bad == "float16":
        x, w, b = x.half(), w.half(), b.half()
    elif bad == "mixed_weights":
        w = w.to(BF16)
    else:
        x, w = x.to(BF16), w.to(BF16)
    with pytest.raises(ValueError, match="fused_dense_lrelu"):
        tfd.fused_dense_lrelu(x, w, b)


@pytest.mark.parametrize("bad", ["float16", "mixed", "kernel_7x7", "kernel_3x2"])
def test_encoder_wrapper_rejects_what_the_kernel_does_not_take(bad):
    plan = (("conv", 8, 3, 1, 1), ("lrelu", 0.2))
    params = {"conv_0_kernel": torch.zeros(8, 5, 3, 3), "conv_0_bias": torch.zeros(8)}
    feats = torch.zeros(2, 6, 6, 5)
    if bad == "float16":
        params, feats = {k: v.half() for k, v in params.items()}, feats.half()
    elif bad == "mixed":
        feats = feats.to(BF16)
    elif bad == "kernel_7x7":
        params["conv_0_kernel"] = torch.zeros(8, 5, 7, 7)
    else:
        params["conv_0_kernel"] = torch.zeros(8, 5, 3, 2)
    with pytest.raises(ValueError, match="fused_encoder_forward"):
        tfe.fused_encoder_forward(params, feats, plan)


# ------------------------------------------------------------- (b) the modules

PLANS = {
    "dx_bn": (j_cfg().dx_plan, (28, 28, 5)),
    "dense_stem": ((("dense", 64), ("reshape", (4, 4, 4)), ("lrelu", 0.2),
                    ("convT", 3, 5, 2, 2, 1), ("tanh",)), (12,)),
    "dense_head": ((("conv", 8, 3, 2, 1), ("lrelu", 0.2), ("flatten",), ("dense", 16),
                    ("lrelu", 0.2), ("drop", 0.5), ("dense", 4), ("sigmoid",)), (9, 9, 3)),
    "mnist_gen": (j_cfg(latent_dim=16).gen_plan, (1, 1, 35)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_sequential_matches_flax_in_bf16(name):
    """Four ulps: up to six layers, each rounding conv output and bias sum
    apart in JAX and summing in another order."""
    plan, in_shape = PLANS[name]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, *in_shape)).astype(np.float32)
    mod = jl.PlanSequential(plan, init_std=0.05, compute_dtype=jnp.bfloat16)
    variables = mod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = _redraw(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.device_get(variables.get("batch_stats", {})))
    ref = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    assert ref.dtype == jnp.bfloat16
    tmod = tl.PlanSequential(plan, in_shape, 0.05, device="cpu", compute_dtype=BF16)
    tmod.load_state_dict(plan_state_dict_from_jax(params, stats))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert out.dtype == BF16
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    _close(out, ref, ulps=4)


def test_attribute_channels_matches_flax_in_bf16():
    """One ulp: a table lookup, a tanh and casts."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 28, 28, 1)).astype(np.float32)
    a = _mnist_attrs(3, rng)
    mod = jl.AttributeChannels(J_MNIST_SPEC, (28, 28), 256, (16, 16), jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), a)["params"]
    ref = mod.apply({"params": params}, jnp.asarray(x), a)
    tmod = tl.AttributeChannels(MNIST_SPEC, (28, 28), 256, (16, 16), device="cpu", compute_dtype=BF16)
    tmod.embed_digit.data = torch.from_numpy(_np(params["embed_digit"]["embedding"]))
    out = tmod(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in a.items()})
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close(out, ref, ulps=1)


def test_attribute_vectors_matches_flax_in_bf16():
    """One ulp: a ten-term bf16 product sum per feature."""
    rng = np.random.default_rng(6)
    a = _mnist_attrs(4, rng, soft=True)
    mod = jl.AttributeVectors(J_MNIST_SPEC, 16, jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(1), a)["params"]
    ref = mod.apply({"params": params}, a)
    tmod = tl.AttributeVectors(MNIST_SPEC, 16, device="cpu", compute_dtype=BF16)
    tmod.embed_digit.data = torch.from_numpy(_np(params["embed_digit"]))
    out = tmod({k: torch.from_numpy(v) for k, v in a.items()})
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close(out, ref, ulps=1)


def _bigan_pair(seed=0, b=4, latent=64):
    rng = np.random.default_rng(seed)
    jm = JBiGAN(j_cfg(latent_dim=latent, compute_dtype=jnp.bfloat16))
    a = _mnist_attrs(b, rng)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    z = rng.normal(0, 1, (b, 1, 1, latent)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.asarray(z), a)["params"], rng)
    tm = bigan_params_from_jax(pE, pG, mnist_bigan_config(latent, BF16), device="cpu")
    return jm, pE, pG, tm, x, z, a, {k: torch.from_numpy(v) for k, v in a.items()}


def test_encoder_matches_jax_in_bf16():
    """Four ulps: five convs; JAX rounds each twice, the fused trunk once."""
    jm, pE, _, tm, x, _, a, ta = _bigan_pair()
    ref = jm.encoder.apply({"params": pE}, jnp.asarray(x), a)
    with torch.no_grad():
        out = tm.encoder(torch.from_numpy(x), ta)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert tuple(out.shape) == (4, 1, 1, 64)
    _close(out, ref, ulps=4)


def test_generator_matches_jax_in_bf16():
    """Four ulps: five transposed convs and a tanh."""
    jm, _, pG, tm, _, z, a, ta = _bigan_pair(seed=1)
    ref = jm.generator.apply({"params": pG}, jnp.asarray(z), a)
    with torch.no_grad():
        out = tm.generator(torch.from_numpy(z), ta)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert tuple(out.shape) == (4, 28, 28, 1)
    _close(out, ref, ulps=4)


def test_audio_generator_dense_stem_matches_jax_in_bf16():
    """The AudioMNIST generator at d = 4: a lone dense stem (``F.linear``),
    five transposed convs, tanh. Four ulps."""
    rng = np.random.default_rng(7)
    jm = JBiGAN(j_audio_cfg(d=4, latent_dim=32, compute_dtype=jnp.bfloat16))
    spec = jm.cfg.attr_spec
    a = {s.name: np.eye(s.n_categories, dtype=np.float32)[rng.integers(0, s.n_categories, 2)]
         for s in spec}
    z = rng.normal(0, 1, (2, 1, 1, 32)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 128, 128, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    pE = jax.device_get(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"])
    pG = _redraw(jm.generator.init({"params": key}, jnp.asarray(z), a)["params"], rng)
    tm = bigan_params_from_jax(pE, pG, audio_mnist_bigan_config(4, 32, BF16), device="cpu")
    ref = jm.generator.apply({"params": pG}, jnp.asarray(z), a)
    with torch.no_grad():
        out = tm.generator(torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in a.items()})
    assert tuple(out.shape) == (2, 128, 128, 1) and out.dtype == torch.float32
    _close(out, ref, ulps=4)


def test_classifier_matches_jax_in_bf16(monkeypatch):
    """The narrow AudioMNIST classifier: seven convs, the dense + LeakyReLU
    head through ``fused_dense_lrelu`` in bf16, a lone dense. Six ulps."""
    rng = np.random.default_rng(8)
    jcfg = dataclasses.replace(jclf.audio_mnist_classifier_config(10, width=0.125),
                               compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tclf.audio_mnist_classifier_config(10, width=0.125),
                               compute_dtype=BF16)
    x = rng.uniform(-1, 1, (4, 128, 128, 1)).astype(np.float32)
    jm = jclf.CNNClassifier(jcfg)
    params = _redraw(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"], rng)
    tm = classifier_params_from_jax(params, tcfg, device="cpu")
    seen = []

    def record(x, w, b, slope):
        seen.append((x.dtype, w.dtype, b.dtype))
        return tfd.fused_dense_lrelu(x, w, b, slope)

    monkeypatch.setattr(tl, "fused_dense_lrelu", record)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert seen == [(BF16, BF16, BF16)]
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref, ulps=6)


def test_engine_counterfactual_matches_jax_in_bf16():
    """The whole MNIST slice in bf16: the attribute SCM and the scaler stay
    float32 (attributes to 1e-5), the images pass five convs and five
    transposed convs in bf16 (eight ulps of a tanh output)."""
    b, latent = 8, 64
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, b) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, b)).astype(np.float32)
    raw = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)],
           "thickness": t, "intensity": i, "slant": s}
    jm = JBiGAN(j_cfg(latent_dim=latent, compute_dtype=jnp.bfloat16))
    key = jax.random.PRNGKey(0)
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), raw)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.zeros((b, 1, 1, latent)), raw)["params"], rng)
    graph = j_build(i.min() - 5, i.max() + 5, s.min() - 0.1, s.max() + 0.1)
    sp, ss = jax.device_get(graph.init(key))
    jscm = JSCM(graph, sp, ss)
    jscaler = JScaler.fit(J_MNIST_SPEC, raw)
    jeng = JEngine(jm, pE, pG, jscm, jscaler)
    teng = CounterfactualEngine(
        bigan_params_from_jax(pE, pG, mnist_bigan_config(latent, BF16), device="cpu"),
        scm_from_jax_state_dict(jax.device_get(jscm.state_dict()), device="cpu"),
        AttributeScaler.from_state_dict(MNIST_SPEC, jscaler.state_dict()), device="cpu")
    do = {"thickness": (t + 2).reshape(-1, 1)}
    jx, ja = jeng.counterfactual(jax.random.PRNGKey(1), jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in raw.items()},
                                 {k: jnp.asarray(v) for k, v in do.items()})
    tx, ta = teng.counterfactual(x, raw, do)
    assert tx.dtype == torch.float32 and tuple(tx.shape) == (b, 28, 28, 1)
    _close(tx, jx, ulps=8)
    for k in ja:
        assert ta[k].dtype == torch.float32
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    _close(teng.reconstruct(x, raw), jeng.reconstruct(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in raw.items()}), ulps=8)


def test_cast_weights_are_cached_and_follow_updates():
    """The bf16 copies of the parameters are made once, and anew after an
    in-place update or a ``load_state_dict``."""
    tmod = tl.PlanSequential((("conv", 4, 3, 1, 1), ("lrelu", 0.2)), (6, 6, 2), 0.05,
                             device="cpu", compute_dtype=BF16)
    with torch.no_grad():
        first = tmod.cast_parameters()
        again = tmod.cast_parameters()
        assert all(first[k] is again[k] for k in first)
        assert first["conv_0_kernel"].dtype == BF16
        tmod.conv_0_kernel.mul_(2.0)
        updated = tmod.cast_parameters()
        assert updated["conv_0_kernel"] is not first["conv_0_kernel"]
        assert updated["conv_0_bias"] is first["conv_0_bias"]
        torch.testing.assert_close(updated["conv_0_kernel"], tmod.conv_0_kernel.to(BF16))
        tmod.load_state_dict({k: torch.ones_like(v) for k, v in tmod.state_dict().items()})
        loaded = tmod.cast_parameters()
        assert float(loaded["conv_0_kernel"].float().min()) == 1.0
    # with a gradient being recorded the cast is part of the graph
    live = tmod.cast_parameters()["conv_0_kernel"]
    assert live.requires_grad and live.grad_fn is not None
