"""The attribute SCMs' MLE ``fit`` in the port against the JAX package's, on
the CPU: one epoch (four Adam steps) from the JAX package's initial
parameters and its permutation.

The JAX ``fit`` draws both from its key: ``graph.init(rng)`` and, per epoch,
``rng, key = split(rng); permutation(key, n_use)``. The test reproduces them
with the same calls and hands them to the port's ``_fit``, which is ``fit``
with both draws replaceable (``init=``, ``perms=``).

Tolerance: Adam(1e-2) moves an element by about ``lr`` a step and passes the
relative error of its gradient on to it, so after four steps parameters are
held to 1e-4 relative plus ``0.01 * lr`` absolute; the flow's running
statistics, which see only the data, to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.scm import audio_mnist as jaudio
from imagecfgen_tpu.scm import mnist as jmnist
from imagecfgen_tpu.scm.module import CategoricalCM as JCategoricalCM
from imagecfgen_torch.scm import audio_mnist as taudio
from imagecfgen_torch.scm import mnist as tmnist
from imagecfgen_torch.scm.module import CategoricalCM

LR = 1e-2
N, BATCH = 1030, 256  # four full batches and a tail that is dropped


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_close(g, w, rtol, atol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=path)


def mnist_attrs(rng):
    t = (rng.gamma(10, 1 / 5, N) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64 + rng.normal(0, 3, N)).astype(np.float32)
    s = rng.normal(0, 0.3, N).astype(np.float32)
    return {"thickness": t, "intensity": i, "slant": s, "digit": rng.integers(0, 10, N)}


@pytest.mark.parametrize("spline", ["rq", "linear"])
def test_mnist_fit_follows_jax(spline):
    attrs = mnist_attrs(np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    ref = jmnist.MNISTAttributeSCM.fit(attrs, steps=1, batch_size=BATCH, rng=key, spline=spline)

    i, s = attrs["intensity"], attrs["slant"]
    graph = jmnist.build_mnist_graph(i.min(), i.max(), s.min(), s.max(), spline=spline)
    init = to_numpy(graph.init(key))
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[1], N // BATCH * BATCH))

    got = tmnist.MNISTAttributeSCM._fit(attrs, 1, BATCH, LR, None, 0, (32, 32), spline, "cpu",
                                        init=init, perms=[perm])
    assert_trees_close(got.params, ref.params, rtol=1e-4, atol=0.01 * LR)
    assert_trees_close(got.state, ref.state, rtol=1e-6, atol=1e-6)
    # the batch-norm flow's running statistics moved off their initial (0, 1)
    assert abs(got.state["thickness"][0]["mean"].item()) > 0.1
    assert not any(t.requires_grad for t in got.params["intensity"][0]["mlp"][0].values())
    # the fitted SCM serves: the same log-likelihood as the JAX SCM's on the data
    obs = {k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in attrs.items() if k != "digit"}
    lp = got.log_prob({k: torch.from_numpy(v) for k, v in obs.items()})
    lp_ref = ref.log_prob({k: jnp.asarray(v) for k, v in obs.items()})
    for k in obs:
        np.testing.assert_allclose(lp[k].detach().numpy(), np.asarray(lp_ref[k]), rtol=1e-3, atol=1e-3)


def test_audio_fit_follows_jax():
    rng = np.random.default_rng(1)
    country = rng.integers(0, 13, N)
    attrs = {k: rng.integers(0, c, N) for k, c in jaudio.CARDINALITIES.items()}
    attrs["country_of_origin"] = country
    attrs["native_speaker"] = (country % 2 + (rng.random(N) < 0.1)) % 2  # depends on its parent
    attrs["accent"] = (country + attrs["native_speaker"]) % 15
    key = jax.random.PRNGKey(0)
    ref = jaudio.AudioMNISTAttributeSCM.fit(attrs, steps=1, batch_size=BATCH, rng=key)

    init = to_numpy(jaudio.build_audio_mnist_graph().init(key))
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[1], N // BATCH * BATCH))
    got = taudio.AudioMNISTAttributeSCM._fit(attrs, 1, BATCH, LR, None, 0, "cpu",
                                             init=init, perms=[perm])
    assert_trees_close(got.params, ref.params, rtol=1e-4, atol=0.01 * LR)
    assert got.state == ref.state == {k: {} for k in jaudio.CARDINALITIES}


def test_fit_draws_its_own_start_and_shuffles():
    """The public ``fit`` starts from ``rng`` and the NLL
    falls; the same seed gives the same SCM."""
    attrs = mnist_attrs(np.random.default_rng(2))
    fit = lambda steps: tmnist.MNISTAttributeSCM.fit(  # noqa: E731
        attrs, steps=steps, batch_size=BATCH, rng=torch.Generator().manual_seed(0), device="cpu")
    start, a, b = fit(0), fit(8), fit(8)
    assert_trees_close(a.params, to_numpy(jax.tree_util.tree_map(lambda t: t.numpy(), b.params)), 0, 0)
    obs = {k: torch.from_numpy(np.asarray(v, np.float32)).reshape(-1, 1)
           for k, v in attrs.items() if k != "digit"}
    nll = lambda scm: -sum(v.mean().item() for v in scm.log_prob(obs).values())  # noqa: E731
    assert nll(a) < nll(start) - 0.5


def test_fit_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    attrs = mnist_attrs(np.random.default_rng(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmnist.MNISTAttributeSCM.fit(attrs, steps=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taudio.AudioMNISTAttributeSCM.fit({k: np.zeros(4, np.int64) for k in taudio.CARDINALITIES},
                                          steps=0)


def test_categorical_fit_params_matches_jax():
    values = np.random.default_rng(0).integers(0, 7, 50)  # classes 7..9 never occur
    got = CategoricalCM.fit_params(torch.from_numpy(values), 10)
    ref = JCategoricalCM.fit_params(jnp.asarray(values), 10)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]), rtol=1e-6)
