"""The port's AudioMNIST attribute SCM against ``imagecfgen_tpu.scm``, with
the JAX SCM's ``state_dict()`` carried across by
``audio_scm_from_jax_state_dict``.

Random draws differ between the frameworks, so each test reproduces the
JAX package's Gumbels with ``jax.random.gumbel`` under the keys the JAX
graph derives, checks that they give the JAX result, and injects them into
the port. Tolerance 1e-5 relative and absolute for logits, log-probs and
abducted noise (f32 MLPs and log-sum-exps with other rounding); class
values must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.scm.audio_mnist import AudioMNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.audio_mnist import build_audio_mnist_graph as j_build
from imagecfgen_torch.core.convert import audio_scm_from_jax_state_dict
from imagecfgen_torch.scm.audio_mnist import CARDINALITIES, AudioMNISTAttributeSCM
from imagecfgen_torch.scm.module import ConditionalCategoricalCM

N = 64
TOL = 1e-5
CONDITIONAL = ("native_speaker", "accent")


def _jax_scm(seed=0):
    rng = np.random.default_rng(seed)
    graph = j_build()
    params, state = jax.device_get(graph.init(jax.random.PRNGKey(seed)))
    for k in ("country_of_origin", "digit", "age", "gender"):
        params[k] = {"logits": rng.normal(size=CARDINALITIES[k]).astype(np.float32)}
    for k in CONDITIONAL:  # logits that depend strongly on the parents
        params[k] = {"mlp": [
            {"w": rng.normal(0, 3 / np.sqrt(layer["w"].shape[0]), layer["w"].shape).astype(np.float32),
             "b": rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)}
            for layer in params[k]["mlp"]]}
    return JSCM(graph, params, state)


def _pair(seed=0):
    jscm = _jax_scm(seed)
    return jscm, audio_scm_from_jax_state_dict(jax.device_get(jscm.state_dict()), device="cpu")


def _obs(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, n, N).astype(np.int32) for k, n in CARDINALITIES.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _gumbels(key, node):
    return np.array(jax.random.gumbel(key, (N, CARDINALITIES[node])))


def _abduction_gumbels(graph, k_noise, obs):
    """The Gumbels ``CausalGraph.recover_noise`` draws: one key per
    fully-observed node, in insertion order."""
    names = [v for v in graph.modules if v in obs and all(u in obs for u in graph.parents(v))]
    keys = jax.random.split(k_noise, len(names))
    return {v: _gumbels(k, v) for k, v in zip(keys, names) if v in CONDITIONAL}


@pytest.mark.parametrize("node", CONDITIONAL)
def test_conditional_categorical_matches_jax(node):
    jscm, tscm = _pair()
    obs = _obs()
    jm, tm = jscm.graph.modules[node], tscm.graph.modules[node]
    assert isinstance(tm, ConditionalCategoricalCM)
    assert (tm.n, tm.context_dim, tm.hidden) == (jm.n, jm.context_dim, jm.hidden)
    jp, tp = jscm.params[node], tscm.params[node]
    jctx = jscm.graph._context(node, obs)
    tctx = tscm.graph._context(node, _t(obs))
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx))

    np.testing.assert_allclose(tm.logits(tp, tctx).numpy(), np.asarray(jm.logits(jp, jctx)),
                               rtol=TOL, atol=TOL)
    jlp, _ = jm.log_prob(jp, {}, obs[node], jctx)
    tlp, _ = tm.log_prob(tp, {}, torch.from_numpy(obs[node]), tctx)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)

    key = jax.random.PRNGKey(5)
    jn = jm.recover_noise(jp, {}, key, obs[node], jctx)
    tn = tm.recover_noise(tp, {}, None, torch.from_numpy(obs[node]), tctx,
                          noise=torch.from_numpy(_gumbels(key, node)))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=TOL, atol=TOL)
    # the posterior Gumbels regenerate the observed class
    assert np.array_equal(tm.generate(tp, {}, tn, tctx).numpy(), obs[node])

    # Gumbel-max under another parent context
    other = _obs(seed=2)
    jctx2, tctx2 = jscm.graph._context(node, other), tscm.graph._context(node, _t(other))
    jg = jm.generate(jp, {}, jn, jctx2)
    assert np.array_equal(tm.generate(tp, {}, tn, tctx2).numpy(), np.asarray(jg))

    # sampling: the JAX draw is argmax(logits + gumbel(key, (B, n)))
    js = jm.sample(jp, {}, key, jctx, N)
    ts = tm.sample(tp, {}, None, tctx, N, noise=torch.from_numpy(_gumbels(key, node)))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_recover_noise_draws_from_generator():
    _, tscm = _pair()
    obs = _t(_obs())
    noise = tscm.recover_noise(torch.Generator().manual_seed(0), obs)
    assert sorted(noise) == sorted(CARDINALITIES)
    for node in CONDITIONAL:
        m = tscm.graph.modules[node]
        ctx = tscm.graph._context(node, obs)
        assert noise[node].shape == (N, CARDINALITIES[node])
        assert torch.equal(m.generate(tscm.params[node], {}, noise[node], ctx), obs[node].long())


@pytest.mark.parametrize("target", ["digit", "country_of_origin"])
def test_sample_cf_matches_jax_with_injected_gumbels(target):
    jscm, tscm = _pair()
    obs = _obs()
    new = (obs[target] + 3) % CARDINALITIES[target]
    key = jax.random.PRNGKey(7)
    jout = jscm.sample_cf(key, obs, {target: jnp.asarray(new)})

    _, k_noise = jax.random.split(key)
    gumbels = _abduction_gumbels(jscm.graph, k_noise, obs)
    jn = jscm.graph.recover_noise(jscm.params, jscm.state, k_noise, obs)
    tn = tscm.recover_noise(None, _t(obs), _t(gumbels))
    for v in jn:
        np.testing.assert_allclose(np.asarray(tn[v]), np.asarray(jn[v]), rtol=TOL, atol=TOL)

    tout = tscm.sample_cf(None, _t(obs), {target: torch.from_numpy(new)}, _t(gumbels))
    assert sorted(tout) == sorted(jout)
    for v in jout:
        assert np.array_equal(np.asarray(tout[v]).reshape(-1), np.asarray(jout[v]).reshape(-1)), v
    assert np.array_equal(tout[target].numpy(), new)
    unchanged = ("age", "gender") + (("country_of_origin", "native_speaker", "accent")
                                     if target == "digit" else ("digit",))
    for v in unchanged:
        assert np.array_equal(tout[v].numpy().reshape(-1), obs[v]), v
    if target == "country_of_origin":  # the children are regenerated under the new parent
        regen = np.asarray(tout["accent"]) != obs["accent"]
        regen |= np.asarray(tout["native_speaker"]) != obs["native_speaker"]
        assert regen.any()


def test_ancestral_sample_matches_jax_with_injected_gumbels():
    jscm, tscm = _pair()
    key = jax.random.PRNGKey(9)
    jout = jscm.sample(key, n=N)
    order = jscm.graph.top_sort()
    noise = {v: _gumbels(k, v) for k, v in zip(jax.random.split(key, len(order)), order)}
    tout = tscm.sample(None, n=N, device="cpu", noise=_t(noise))
    for v in jout:
        assert np.array_equal(tout[v].numpy(), np.asarray(jout[v])), v


def test_log_prob_matches_jax():
    jscm, tscm = _pair()
    obs = _obs()
    jlp, tlp = jscm.log_prob(obs), tscm.log_prob(_t(obs))
    assert sorted(jlp) == sorted(tlp) == sorted(CARDINALITIES)
    for v in jlp:
        np.testing.assert_allclose(tlp[v].numpy(), np.asarray(jlp[v]), rtol=TOL, atol=TOL)


def test_state_dict_round_trip_and_layout():
    jscm, tscm = _pair()
    again = AudioMNISTAttributeSCM.from_state_dict(tscm.state_dict(), device="cpu")
    mlp = again.params["accent"]["mlp"]
    assert [tuple(layer["w"].shape) for layer in mlp] == [(15, 128), (128, 64), (64, 15)]
    for j, t in zip(jscm.params["accent"]["mlp"], mlp):
        np.testing.assert_array_equal(t["w"].numpy(), j["w"])
        np.testing.assert_array_equal(t["b"].numpy(), j["b"])
    assert again.to("cpu").params["digit"]["logits"].device.type == "cpu"
