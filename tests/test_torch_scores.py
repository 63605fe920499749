"""The whole AudioMNIST slice: ``cf_effectiveness_score`` of the JAX package
and of the port, given the same carried weights (BiGAN, attribute SCM,
classifier), observations and random draws, give the same counterfactual
images, classifier logits, predictions and score.

The JAX draws are reproduced with ``jax.random.gumbel`` under the keys the
JAX functions derive, checked against the JAX result, and injected into the
port. Tolerances: 2e-4 absolute and 1e-4 relative for the images, which
pass through the six-conv encoder and the dense-stem generator (f32 sums in
another order, as in ``tests/test_torch_bigan.py``); 1e-4 absolute for the
logits of the classifier's seven convs and two dense layers, which see
images that agree far closer than that bound; predictions must agree
wherever the top-two logit margin exceeds the logit tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.cf.engine import CounterfactualEngine as JEngine
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.metrics import scores as jscores
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.models.bigan import AUDIO_MNIST_SPEC as J_SPEC
from imagecfgen_tpu.models.bigan import BiGAN as JBiGAN
from imagecfgen_tpu.models.bigan import audio_mnist_bigan_config as j_cfg
from imagecfgen_tpu.scm.audio_mnist import AudioMNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.audio_mnist import build_audio_mnist_graph as j_build
from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.core.attributes import AttributeScaler
from imagecfgen_torch.core.convert import (
    audio_scm_from_jax_state_dict,
    bigan_params_from_jax,
    classifier_params_from_jax,
)
from imagecfgen_torch.metrics import scores
from imagecfgen_torch.models.bigan import AUDIO_MNIST_SPEC, audio_mnist_bigan_config
from imagecfgen_torch.models.classifier import audio_mnist_classifier_config
from imagecfgen_torch.scm.audio_mnist import CARDINALITIES

B, D, LATENT, WIDTH, ROUNDS = 8, 8, 64, 0.125, 2
IMG_TOL, LOGIT_TOL = 2e-4, 1e-4
CONDITIONAL = ("native_speaker", "accent")


def _redraw(params, rng):
    """N(0, 1/sqrt(fan_in)) kernels; a stride-2 transposed conv sums a quarter
    of its taps per output, so its kernels get twice that."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = (1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name
               else 1.0 if "embed" in name else 0.1)
        if "convT" in name and "kernel" in name:
            std *= 2
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def _jax_scm(rng):
    graph = j_build()
    params, state = jax.device_get(graph.init(jax.random.PRNGKey(0)))
    for k in ("country_of_origin", "digit", "age", "gender"):
        params[k] = {"logits": rng.normal(size=CARDINALITIES[k]).astype(np.float32)}
    for k in CONDITIONAL:
        params[k] = {"mlp": [
            {"w": rng.normal(0, 3 / np.sqrt(layer["w"].shape[0]), layer["w"].shape).astype(np.float32),
             "b": rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)}
            for layer in params[k]["mlp"]]}
    return JSCM(graph, params, state)


def _gumbels(key, n):
    return np.array(jax.random.gumbel(key, (B, n)))


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32)
    attrs = {a.name: np.eye(a.n_categories, dtype=np.float32)[rng.integers(0, a.n_categories, B)]
             for a in J_SPEC}
    key = jax.random.PRNGKey(0)
    jm = JBiGAN(j_cfg(d=D, latent_dim=LATENT))
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), attrs)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.zeros((B, 1, 1, LATENT)), attrs)["params"], rng)
    jc = jclf.CNNClassifier(jclf.audio_mnist_classifier_config(10, WIDTH))
    pC = _redraw(jc.init({"params": key}, jnp.asarray(x))["params"], rng)
    jscm = _jax_scm(rng)
    jscaler = JScaler.fit(J_SPEC, {})
    jeng = JEngine(jm, pE, pG, jscm, jscaler)

    tm = bigan_params_from_jax(pE, pG, audio_mnist_bigan_config(D, LATENT), device="cpu")
    tscm = audio_scm_from_jax_state_dict(jax.device_get(jscm.state_dict()), device="cpu")
    tscaler = AttributeScaler.from_state_dict(AUDIO_MNIST_SPEC, jscaler.state_dict())
    teng = CounterfactualEngine(tm, tscm, tscaler, device="cpu")
    tc = classifier_params_from_jax(pC, audio_mnist_classifier_config(10, WIDTH), device="cpu")
    return jeng, (jc, pC), teng, tc, x, attrs


@pytest.mark.parametrize("node", ["digit", "accent", "native_speaker"])
def test_resample_excluding_matches_jax_with_injected_gumbels(slice_pair, node):
    jeng, _, teng, _, _, attrs = slice_pair
    jscm, tscm = jeng.scm, teng.scm
    jobs = jeng._to_graph_obs(attrs)
    tobs = teng._to_graph_obs({k: torch.from_numpy(v) for k, v in attrs.items()})
    key = jax.random.PRNGKey(4)
    jnew = np.asarray(jscores.resample_excluding(jscm.graph, jscm.params, jscm.state, key, node, jobs))
    g = _gumbels(key, CARDINALITIES[node])
    # jax.random.categorical draws argmax(logits + gumbel(key, logits.shape))
    module = jscm.graph.modules[node]
    ctx = jscm.graph._context(node, jobs)
    logits = (module.logits(jscm.params[node], ctx) if node in CONDITIONAL
              else np.broadcast_to(jscm.params[node]["logits"], (B, CARDINALITIES[node])))
    masked = np.where(np.eye(CARDINALITIES[node], dtype=bool)[np.asarray(jobs[node])], -np.inf, logits)
    assert np.array_equal(np.argmax(masked + g, axis=-1), jnew)

    tnew = scores.resample_excluding(tscm.graph, tscm.params, tscm.state, None, node, tobs,
                                     torch.from_numpy(g))
    assert np.array_equal(tnew.numpy(), jnew)
    assert (tnew != tobs[node]).all()


def test_resample_excluding_draws_from_generator(slice_pair):
    _, _, teng, _, _, attrs = slice_pair
    tscm = teng.scm
    obs = teng._to_graph_obs({k: torch.from_numpy(v) for k, v in attrs.items()})
    new = scores.resample_excluding(tscm.graph, tscm.params, tscm.state,
                                    torch.Generator().manual_seed(0), "digit", obs)
    assert new.shape == (B,) and (new != obs["digit"]).all()


def test_cf_effectiveness_score_matches_jax(slice_pair):
    jeng, (jc, pC), teng, tc, x, attrs = slice_pair
    jseen, tseen = [], []

    def j_classify(img):
        logits = jc.apply({"params": pC}, img)
        jseen.append((np.asarray(img), np.asarray(logits)))
        return logits

    def t_classify(img):
        logits = tc(img)
        tseen.append((img.numpy(), logits.numpy()))
        return logits

    key = jax.random.PRNGKey(11)
    jscore = jscores.cf_effectiveness_score(jeng, j_classify, jnp.asarray(x), attrs, key,
                                            target_attr="digit", mc_rounds=ROUNDS)

    # the draws of each round, as cf_effectiveness_score and sample_cf derive them
    jobs = jeng._to_graph_obs(attrs)
    tobs = teng._to_graph_obs({k: torch.from_numpy(v) for k, v in attrs.items()})
    names = list(jeng.scm.graph.modules)
    noise, rng = [], key
    for _ in range(ROUNDS):
        k1, k2, rng = jax.random.split(rng, 3)
        _, k_noise = jax.random.split(k2)
        keys = dict(zip(names, jax.random.split(k_noise, len(names))))
        noise.append({
            "resample": torch.from_numpy(_gumbels(k1, CARDINALITIES["digit"])),
            "abduction": {v: torch.from_numpy(_gumbels(keys[v], CARDINALITIES[v])) for v in CONDITIONAL},
        })
        # the reproduced Gumbels give the JAX abduction
        jn = jeng.scm.graph.recover_noise(jeng.scm.params, jeng.scm.state, k_noise, jobs)
        tn = teng.scm.recover_noise(None, tobs, noise[-1]["abduction"])
        for v in CONDITIONAL:
            np.testing.assert_allclose(tn[v].numpy(), np.asarray(jn[v]), rtol=1e-5, atol=1e-5)

    tscore = scores.cf_effectiveness_score(teng, t_classify, torch.from_numpy(x), attrs, None,
                                           target_attr="digit", mc_rounds=ROUNDS, noise=noise)
    assert isinstance(tscore, float) and isinstance(jscore, float)
    assert len(jseen) == len(tseen) == ROUNDS
    for (jx, jl), (tx, tl) in zip(jseen, tseen):
        assert tx.shape == jx.shape == (B, 128, 128, 1)
        np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=IMG_TOL)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert np.array_equal(tl.argmax(-1)[clear], jl.argmax(-1)[clear])
    assert tscore == jscore


def test_generator_score_matches_jax(slice_pair):
    """Classifier accuracy on G(z, a) for given attributes, with the JAX
    latents injected."""
    jeng, (jc, pC), teng, tc, _, attrs = slice_pair
    key = jax.random.PRNGKey(5)
    jscore = jscores.generator_score(
        lambda z, a: jeng.bigan.generator.apply({"params": jeng.params_G}, z, a),
        lambda img: jc.apply({"params": pC}, img), jeng.scm, jeng.scaler, key,
        latent_dim=LATENT, attrs=attrs)
    _, k2, _ = jax.random.split(key, 3)
    z = torch.from_numpy(np.array(jax.random.normal(k2, (B, 1, 1, LATENT))))
    tscore = scores.generator_score(teng.bigan.generator, tc, teng.scm, teng.scaler, None,
                                    latent_dim=LATENT, attrs=attrs, device="cpu", z=z)
    assert isinstance(tscore, float) and tscore == jscore


def test_generator_score_draws_attributes_from_the_scm(slice_pair):
    _, _, teng, tc, _, _ = slice_pair
    score = scores.generator_score(teng.bigan.generator, tc, teng.scm, teng.scaler,
                                   torch.Generator().manual_seed(0), n=6, latent_dim=LATENT,
                                   device="cpu")
    assert 0.0 <= score <= 1.0
