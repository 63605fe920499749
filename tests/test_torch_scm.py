"""The port's MNIST attribute SCM against ``imagecfgen_tpu.scm``, with the
JAX SCM's ``state_dict()`` carried across by ``scm_from_jax_state_dict``.

Random draws differ between the frameworks, so the tests take the JAX
package's own noise (from its keys) and inject it into the port. Tolerance
1e-5 relative and absolute (f32 flows evaluated with other rounding); the
linear-rational spline's inverse takes 5e-5, as in ``test_torch_flows.py``.
"""
import jax
import numpy as np
import pytest
import torch

from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
from imagecfgen_torch.core.convert import scm_from_jax_state_dict
from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

N = 48
BOUNDS = (64.0, 255.0, -0.9, 0.9)


def _tol(spline):
    return 5e-5 if spline == "linear" else 1e-5


def _jax_scm(spline, seed=0):
    rng = np.random.default_rng(seed)
    graph = j_build(*BOUNDS, spline=spline)
    params, state = jax.device_get(graph.init(jax.random.PRNGKey(seed)))
    params["slant"] = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.7, np.shape(a)).astype(np.float32), params["slant"])
    params["thickness"] = ({"log_gamma": np.float32([0.3]), "beta": np.float32([-0.2])}, {})
    state["thickness"] = ({"mean": np.float32([1.0]), "var": np.float32([0.1])}, {})
    params["digit"] = {"logits": rng.normal(size=10).astype(np.float32)}
    return JSCM(graph, params, state)


def _obs(rng):
    t = rng.gamma(10, 1 / 5, N).astype(np.float32) + 0.5
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).clip(65, 254).astype(np.float32)
    s = rng.uniform(-0.85, 0.85, N).astype(np.float32)
    d = rng.integers(0, 10, N)
    return {"thickness": t.reshape(-1, 1), "intensity": i.reshape(-1, 1),
            "slant": s.reshape(-1, 1), "digit": d}


def _pair(spline, seed=0):
    jscm = _jax_scm(spline, seed)
    sd = jax.device_get(jscm.state_dict())
    return jscm, scm_from_jax_state_dict(sd, device="cpu")


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _assert_dicts(tout, jout, tol):
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("spline", ["rq", "linear"])
def test_log_prob_matches_jax(spline):
    jscm, tscm = _pair(spline)
    obs = _obs(np.random.default_rng(1))
    _assert_dicts(tscm.log_prob(_t(obs)), jscm.log_prob(obs), _tol(spline))


@pytest.mark.parametrize("spline", ["rq", "linear"])
def test_recover_noise_matches_jax(spline):
    jscm, tscm = _pair(spline)
    obs = _obs(np.random.default_rng(2))
    _assert_dicts(tscm.recover_noise(None, _t(obs)),
                  jscm.recover_noise(jax.random.PRNGKey(0), obs), _tol(spline))


def _jax_noise(jscm, key, obs, n):
    """The exogenous draws ``graph.sample`` makes from ``key``."""
    order = jscm.graph.top_sort()
    noise = {}
    for k, v in zip(jax.random.split(key, len(order)), order):
        if v in obs:
            continue
        shape = (n, 10) if v == "digit" else (n, 1)
        draw = jax.random.gumbel if v == "digit" else jax.random.normal
        noise[v] = torch.from_numpy(np.array(draw(k, shape)))
    return noise


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("spline", ["rq", "linear"])
def test_sample_with_injected_noise_matches_jax(spline, partial):
    jscm, tscm = _pair(spline)
    key = jax.random.PRNGKey(5)
    obs = {"thickness": _obs(np.random.default_rng(3))["thickness"]} if partial else {}
    ref = jscm.graph.sample(jscm.params, jscm.state, key, dict(obs), n=N)
    noise = _jax_noise(jscm, key, obs, N)
    out = tscm.graph.sample(tscm.params, tscm.state, None, _t(obs), n=N, noise=noise)
    _assert_dicts(out, ref, 1e-5)


INTERVENTIONS = {
    "thickness+2": lambda o: {"thickness": o["thickness"] + 2},
    "digit": lambda o: {"digit": (o["digit"] + 3) % 10},
    "intensity": lambda o: {"intensity": np.full((N, 1), 120.0, np.float32)},
}


@pytest.mark.parametrize("iv", sorted(INTERVENTIONS))
@pytest.mark.parametrize("spline", ["rq", "linear"])
def test_sample_cf_matches_jax(spline, iv):
    jscm, tscm = _pair(spline)
    obs = _obs(np.random.default_rng(4))
    do = INTERVENTIONS[iv](obs)
    ref = jscm.sample_cf(jax.random.PRNGKey(0), obs, do)
    out = tscm.sample_cf(None, _t(obs), _t(do))
    _assert_dicts(out, ref, _tol(spline))
    if iv == "thickness+2":
        assert torch.equal(out["thickness"], _t(do)["thickness"])
        assert torch.equal(out["digit"], _t(obs)["digit"])


def test_state_dict_round_trip_and_init():
    graph = build_mnist_graph(*BOUNDS, cond_hidden=(10,), spline="linear")
    params, state = graph.init(torch.Generator().manual_seed(0), "cpu")
    scm = MNISTAttributeSCM(graph, params, state)
    sd = scm.state_dict()
    assert sd["arch"] == {"cond_hidden": (10,), "spline": "linear"}
    again = MNISTAttributeSCM.from_state_dict(sd, device="cpu")
    obs = _t(_obs(np.random.default_rng(6)))
    for k, v in scm.log_prob(obs).items():
        assert torch.equal(v, again.log_prob(obs)[k])
    assert graph.top_sort() == j_build(*BOUNDS).top_sort()
    assert [tuple(np.shape(w["w"])) for w in params["intensity"][0]["mlp"]] == [(1, 10), (10, 2)]


def test_graph_rejects_cycles():
    from imagecfgen_torch.scm.graph import CausalGraph
    from imagecfgen_torch.scm.module import CategoricalCM

    g = CausalGraph()
    g.add_node("a", CategoricalCM(2))
    g.add_node("b", CategoricalCM(2))
    g.add_edge("a", "b")
    g.add_edge("b", "a")
    with pytest.raises(ValueError):
        g.top_sort()


def test_jax_inputs_are_plain_numpy():
    """The carried state dict holds numpy leaves only: no JAX type crosses."""
    jscm, tscm = _pair("rq")
    leaves = jax.tree_util.tree_leaves(jax.device_get(jscm.state_dict())["params"])
    assert all(isinstance(a, (np.ndarray, np.generic)) for a in leaves)
    assert all(isinstance(t, torch.Tensor)
               for t in jax.tree_util.tree_leaves(tscm.params, is_leaf=torch.is_tensor))
