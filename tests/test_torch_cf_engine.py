"""The whole slice: the JAX ``CounterfactualEngine`` and the port's, given
the same carried weights, SCM, scaler and observations, give the same
counterfactual images, counterfactual attributes and reconstructions.

Tolerances: 1e-5 relative and absolute for the attributes (f32 flows);
2e-4 absolute and 1e-4 relative for the images, which pass through the
five-conv encoder and the five-deconv generator (f32 sums in another order,
as in ``tests/test_pallas_ops.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.cf.engine import CounterfactualEngine as JEngine
from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_SPEC
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.models.bigan import BiGAN as JBiGAN
from imagecfgen_tpu.models.bigan import mnist_bigan_config as j_cfg
from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeScaler
from imagecfgen_torch.core.convert import bigan_params_from_jax, scm_from_jax_state_dict
from imagecfgen_torch.models.bigan import mnist_bigan_config

B, LATENT = 8, 64
ATTR_TOL, IMG_TOL = 1e-5, 2e-4


def _redraw(params, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = (1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name
               else 1.0 if "embed" in name else 0.1)
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, B) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, B)).astype(np.float32)
    raw = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)],
           "thickness": t, "intensity": i, "slant": s}

    jm = JBiGAN(j_cfg(latent_dim=LATENT))
    key = jax.random.PRNGKey(0)
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), raw)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.zeros((B, 1, 1, LATENT)), raw)["params"], rng)
    graph = j_build(i.min() - 5, i.max() + 5, s.min() - 0.1, s.max() + 0.1)
    sp, ss = jax.device_get(graph.init(key))
    jscm = JSCM(graph, sp, ss)
    jscaler = JScaler.fit(J_SPEC, raw)
    jeng = JEngine(jm, pE, pG, jscm, jscaler)

    tm = bigan_params_from_jax(pE, pG, mnist_bigan_config(LATENT), device="cpu")
    tscm = scm_from_jax_state_dict(jax.device_get(jscm.state_dict()), device="cpu")
    tscaler = AttributeScaler.from_state_dict(MNIST_SPEC, jscaler.state_dict())
    teng = CounterfactualEngine(tm, tscm, tscaler, device="cpu")
    return jeng, teng, x, raw


INTERVENTIONS = {
    "thickness+2": lambda raw: {"thickness": (raw["thickness"] + 2).reshape(-1, 1)},
    "digit": lambda raw: {"digit": (raw["digit"].argmax(1) + 4) % 10},
    "thickness+digit": lambda raw: {"thickness": (raw["thickness"] + 1).reshape(-1, 1),
                                    "digit": np.full(B, 7)},
    # the hard battery's compound held-out intervention (--held-out-shift 1.5 32 0.4)
    "compound": lambda raw: {"digit": (raw["digit"].argmax(1) + 4) % 10,
                             "thickness": (raw["thickness"] + 1.5).reshape(-1, 1),
                             "intensity": (raw["intensity"] + 32).reshape(-1, 1),
                             "slant": (raw["slant"] + 0.4).reshape(-1, 1)},
}


@pytest.mark.parametrize("iv", sorted(INTERVENTIONS))
def test_counterfactual_matches_jax(engines, iv):
    jeng, teng, x, raw = engines
    do = INTERVENTIONS[iv](raw)
    jx, ja = jeng.counterfactual(jax.random.PRNGKey(1), jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in raw.items()},
                                 {k: jnp.asarray(v) for k, v in do.items()})
    tx, ta = teng.counterfactual(x, raw, do)
    assert tuple(tx.shape) == jx.shape == (B, 28, 28, 1)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=IMG_TOL)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), rtol=ATTR_TOL, atol=ATTR_TOL,
                                   err_msg=k)
    # the counterfactual is not the factual image
    assert float(np.abs(tx.numpy() - teng.reconstruct(x, raw).numpy()).max()) > 1e-3


def test_reconstruct_matches_jax(engines):
    jeng, teng, x, raw = engines
    ref = jeng.reconstruct(jnp.asarray(x), {k: jnp.asarray(v) for k, v in raw.items()})
    out = teng.reconstruct(x, raw)
    assert tuple(out.shape) == ref.shape == (B, 28, 28, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=IMG_TOL)


def test_engine_runs_from_the_ports_own_init():
    """Built with the port's initialisers alone, on the CPU: finite images in
    [-1, 1] and the intervened thickness passed through."""
    from imagecfgen_torch.models.bigan import BiGAN
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    g = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    t = (rng.gamma(10, 1 / 5, 4) + 0.5).astype(np.float32)
    raw = {"digit": np.eye(10, dtype=np.float32)[[1, 2, 3, 4]], "thickness": t,
           "intensity": rng.uniform(70, 250, 4).astype(np.float32),
           "slant": rng.uniform(-0.5, 0.5, 4).astype(np.float32)}
    graph = build_mnist_graph(64.0, 255.0, -0.6, 0.6)
    scm = MNISTAttributeSCM(graph, *graph.init(g, "cpu"))
    eng = CounterfactualEngine(BiGAN(mnist_bigan_config(), "cpu", g), scm,
                               AttributeScaler.fit(MNIST_SPEC, raw), device="cpu")
    x = rng.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    x_cf, cf = eng.counterfactual(x, raw, {"thickness": (t + 2).reshape(-1, 1)})
    assert torch.isfinite(x_cf).all() and float(x_cf.abs().max()) <= 1.0
    assert torch.equal(cf["thickness"], torch.from_numpy(t + 2))
    assert torch.equal(cf["digit"], torch.from_numpy(raw["digit"]))
