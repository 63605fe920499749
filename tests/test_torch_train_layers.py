"""Train mode of the port's plan interpreter and its ``Discriminator`` against
the JAX package, on the CPU, at a small size.

Both sides get the same dropout masks: the JAX side through a stand-in for
``imagecfgen_tpu.models.layers.channel_dropout`` that reads its keep masks
from a queue (the JAX package is not changed), the port through ``masks=``.
Weights are redrawn with numpy at N(0, 1/sqrt(fan_in)) so activations stay
O(1). Tolerance: 1e-4 relative and 2e-5 absolute on outputs (a stack of up
to six convs and four batch norms summed in float32 in another order), 1e-5
relative and 1e-6 absolute on the running statistics.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import layers as jlayers
from imagecfgen_torch.core.convert import (
    discriminator_from_jax,
    plan_state_dict_from_jax,
)
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models.layers import PlanSequential

OUT_TOL = dict(rtol=1e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def narrow_plan(plan, factor, keep_last=True):
    """The plan with every conv's channel count divided by ``factor`` (the
    last conv keeps its own when ``keep_last``)."""
    convs = [i for i, op in enumerate(plan) if op[0] in ("conv", "convT")]
    out = []
    for i, op in enumerate(plan):
        if op[0] in ("conv", "convT") and not (keep_last and i == convs[-1]):
            op = (op[0], max(op[1] // factor, 1), *op[2:])
        out.append(op)
    return tuple(out)


def narrow_config(mod, domain):
    """A small config of the same structure, built the same way for either
    package: MNIST with every width an eighth (latent 32), AudioMNIST at
    d = 4 and latent 32 on 128x128 inputs."""
    if domain == "audio":
        return mod.audio_mnist_bigan_config(d=4, latent_dim=32)
    cfg = mod.mnist_bigan_config(latent_dim=32)
    return dataclasses.replace(
        cfg,
        enc_plan=narrow_plan(cfg.enc_plan, 8), gen_plan=narrow_plan(cfg.gen_plan, 8),
        dx_plan=narrow_plan(cfg.dx_plan, 8, keep_last=False),
        dz_plan=narrow_plan(cfg.dz_plan, 8, keep_last=False),
        dxz_plan=narrow_plan(cfg.dxz_plan, 8),
    )


def redraw(params, rng):
    """Every leaf redrawn with numpy: kernels N(0, 1/sqrt(fan_in)), embedding
    tables N(0, 1), batch-norm scales near 1, everything else N(0, 0.1)."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        if "embed" in name:
            return rng.normal(0, 1.0, leaf.shape).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


class MaskQueue:
    """Stands in for ``channel_dropout``: keeps come from ``self.masks``."""

    def __init__(self):
        self.masks = []

    def __call__(self, mod, x, rate, deterministic):
        if deterministic or rate == 0.0:
            return x
        keep = jnp.asarray(self.masks.pop(0))
        assert keep.shape == (x.shape[0], 1, 1, x.shape[-1])
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


@pytest.fixture
def mask_queue(monkeypatch):
    queue = MaskQueue()
    monkeypatch.setattr(jlayers, "channel_dropout", queue)
    return queue


def draw_masks(module, batch, rng):
    """Keep masks for one train-mode forward of a port module, from numpy."""
    specs = (module.drop_specs if isinstance(module, PlanSequential) else
             [s for part in (module.dx, module.dz, module.dxz) for s in part.drop_specs])
    return [rng.random((batch, *shape)) >= rate for rate, shape in specs]


def attrs_for(spec, b, rng):
    a = {s.name: np.eye(s.n_categories, dtype=np.float32)[rng.integers(0, s.n_categories, b)]
         for s in spec.categorical}
    a.update({s.name: rng.uniform(-1, 1, b).astype(np.float32) for s in spec.continuous})
    return a


PLAN = (
    ("drop2d", 0.2),
    ("conv", 6, 3, 1, 0), ("lrelu", 0.1),
    ("drop2d", 0.5), ("bn",),
    ("conv", 8, 3, 2, 0), ("lrelu", 0.1),
    ("bn",), ("drop2d", 0.0),
    ("flatten",), ("dense", 5), ("lrelu", 0.2), ("dense", 3),
)


def test_plan_train_mode_matches_jax(mask_queue):
    """Two train-mode calls: outputs, then the running buffers they left."""
    rng = np.random.default_rng(0)
    jm = jlayers.PlanSequential(PLAN, None)
    xs = [rng.normal(0.3, 1.2, (8, 10, 10, 3)).astype(np.float32) for _ in range(2)]
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(xs[0]))
    params = redraw(variables["params"], rng)
    stats = jax.device_get(variables["batch_stats"])

    tm = PlanSequential(PLAN, (10, 10, 3), None, "cpu")
    tm.load_state_dict(plan_state_dict_from_jax(params, stats))
    assert [r for r, _ in tm.drop_specs] == [0.2, 0.5]  # rate 0 draws nothing

    for x in xs:
        masks = draw_masks(tm, 8, rng)
        mask_queue.masks = list(masks)
        ref, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        stats = upd["batch_stats"]
        assert not mask_queue.masks
        out = tm(torch.from_numpy(x), train=True, masks=[torch.from_numpy(m) for m in masks])
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **OUT_TOL)
    for i in range(2):
        bn = getattr(tm, f"bn_{i}")
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats[f"bn_{i}"]["mean"]), **STAT_TOL)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats[f"bn_{i}"]["var"]), **STAT_TOL)
    # eval mode after training reads the moved buffers
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
    with torch.no_grad():
        out = tm(torch.from_numpy(xs[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OUT_TOL)


def test_batch_norm_stores_the_biased_variance():
    """flax keeps the biased batch variance in its running statistics;
    ``torch.nn.BatchNorm2d`` would keep the unbiased one."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (4, 5, 5, 3)).astype(np.float32))
    tm = PlanSequential((("bn",),), (5, 5, 3), None, "cpu")
    tm(x, train=True)
    flat = x.reshape(-1, 3)
    np.testing.assert_allclose(tm.bn_0.var.numpy(),
                               0.9 + 0.1 * flat.var(0, unbiased=False).numpy(), rtol=1e-5)
    np.testing.assert_allclose(tm.bn_0.mean.numpy(), 0.1 * flat.mean(0).numpy(), rtol=1e-5)
    before = tm.bn_0.var.clone()
    tm(x, train=True, update_stats=False)
    assert torch.equal(tm.bn_0.var, before)


def test_element_dropout_and_mask_checks():
    plan = (("drop", 0.25), ("dense", 4))
    tm = PlanSequential(plan, (6,), None, "cpu", torch.Generator().manual_seed(0))
    assert tm.drop_specs == [(0.25, (6,))]
    x = torch.ones(5, 6)
    keep = torch.rand(5, 6, generator=torch.Generator().manual_seed(1)) >= 0.25
    out = tm(x, train=True, masks=[keep])
    expect = torch.nn.functional.linear(keep.float() / 0.75, tm.dense_0_kernel, tm.dense_0_bias)
    np.testing.assert_allclose(out.detach().numpy(), expect.detach().numpy(), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(tm(x), torch.nn.functional.linear(x, tm.dense_0_kernel, tm.dense_0_bias))
    with pytest.raises(ValueError, match="dropout masks"):
        tm(x, train=True, masks=[])
    with pytest.raises(ValueError, match="rate"):
        PlanSequential((("drop", 1.0),), (6,), None, "cpu")


def test_masks_come_from_the_generator():
    cfg = narrow_config(tbigan, "mnist")
    D = tbigan.Discriminator(cfg, "cpu", torch.Generator().manual_seed(0))
    a = D.draw_masks(64, torch.Generator().manual_seed(3), "cpu")
    b = D.draw_masks(64, torch.Generator().manual_seed(3), "cpu")
    assert len(a) == 10 and all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].shape == (64, 1, 1, 5) and a[0].dtype == torch.bool
    rates = [r for part in (D.dx, D.dz, D.dxz) for r, _ in part.drop_specs]
    for keep, rate in zip(a, rates):
        if keep.numel() >= 2048:  # three standard errors of a Bernoulli mean
            assert abs(keep.float().mean().item() - (1 - rate)) < 3 * 0.5 / np.sqrt(keep.numel())
    x = torch.zeros(64, 28, 28, 1)
    z = torch.zeros(64, 1, 1, 32)
    attrs = {k: torch.from_numpy(v) for k, v in
             attrs_for(cfg.attr_spec, 64, np.random.default_rng(0)).items()}
    one = D(x, z, attrs, train=True, generator=torch.Generator().manual_seed(5), update_stats=False)
    two = D(x, z, attrs, train=True, generator=torch.Generator().manual_seed(5), update_stats=False)
    assert torch.equal(one, two)


def discriminator_pair(domain, seed=0, b=8):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = narrow_config(jbigan, domain), narrow_config(tbigan, domain)
    h, w = jcfg.image_size
    x = rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32)
    z = rng.normal(0, 1, (b, 1, 1, jcfg.latent_dim)).astype(np.float32)
    a = attrs_for(tcfg.attr_spec, b, rng)
    jm = jbigan.Discriminator(jcfg)
    variables = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), jnp.asarray(z), a)
    vars_D = {"params": redraw(variables["params"], rng),
              "batch_stats": jax.device_get(variables.get("batch_stats", {}))}
    tm = discriminator_from_jax(vars_D, tcfg, device="cpu")
    return jm, vars_D, tm, x, z, a, rng


@pytest.mark.parametrize("domain", ["mnist", "audio"])
def test_discriminator_plans_match_jax(domain):
    for t, j in ((narrow_config(tbigan, domain), narrow_config(jbigan, domain)),
                 (getattr(tbigan, f"{'audio_' if domain == 'audio' else ''}mnist_bigan_config")(),
                  getattr(jbigan, f"{'audio_' if domain == 'audio' else ''}mnist_bigan_config")())):
        assert (t.dx_plan, t.dz_plan, t.dxz_plan) == (j.dx_plan, j.dz_plan, j.dxz_plan)
        assert (t.enc_plan, t.gen_plan) == (j.enc_plan, j.gen_plan)


@pytest.mark.parametrize("domain", ["mnist", "audio"])
def test_discriminator_eval_matches_jax(domain):
    jm, vars_D, tm, x, z, a, _ = discriminator_pair(domain)
    ref = jm.apply(vars_D, jnp.asarray(x), jnp.asarray(z), a)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in a.items()})
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (8, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OUT_TOL)


@pytest.mark.parametrize("domain", ["mnist", "audio"])
def test_discriminator_train_matches_jax(domain, mask_queue):
    jm, vars_D, tm, x, z, a, rng = discriminator_pair(domain, seed=1)
    masks = draw_masks(tm, 8, rng)
    assert len(masks) == (10 if domain == "mnist" else 0)
    mask_queue.masks = list(masks)
    ref, upd = jm.apply(vars_D, jnp.asarray(x), jnp.asarray(z), a, train=True,
                        mutable=["batch_stats"])
    assert not mask_queue.masks
    out = tm(torch.from_numpy(x), torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in a.items()},
             train=True, masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **OUT_TOL)
    for name, stat in upd.get("batch_stats", {}).get("dx", {}).items():
        bn = getattr(tm.dx, name)
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stat["mean"]), **STAT_TOL)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(stat["var"]), **STAT_TOL)
    assert (domain == "mnist") == bool(upd.get("batch_stats"))
    with pytest.raises(ValueError, match="dropout masks"):
        tm(torch.from_numpy(x), torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in a.items()},
           train=True, masks=[torch.ones(1, dtype=torch.bool)] * 11)
