"""The port's bijectors and distributions against the JAX package's.

Each case draws its parameters, state and inputs with numpy and hands the
same values to both packages. Tolerance 1e-5 relative and absolute: the same
f32 formulas, evaluated with other rounding of transcendental functions.
The linear-rational spline's inverse takes 5e-5: it solves for the bin
position from differences of nearly equal terms, and against a float64
evaluation of the same formula both packages' f32 results lie up to 4e-5
away.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.flows import bijectors as jb
from imagecfgen_tpu.flows import distributions as jd
from imagecfgen_torch.flows import bijectors as tb
from imagecfgen_torch.flows import distributions as td
from imagecfgen_torch.scm.graph import tree_map

TOL = 1e-5
B = 64


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _redraw(tree, rng, std):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, std, np.shape(a)).astype(np.float32), jax.device_get(tree))


def _case(name, rng):
    """(jax bijector, torch bijector, params, state, forward input,
    inverse input, context)."""
    n01 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ctx = None
    if name == "affine":
        kw = dict(loc=1.5, scale=-2.5)
        jbij, tbij = jb.AffineT(**kw), tb.AffineT(**kw)
        x, y = n01(B, 3), n01(B, 3)
    elif name == "exp":
        jbij, tbij = jb.ExpT(), tb.ExpT()
        x, y = n01(B, 1), np.exp(n01(B, 1))
    elif name == "sigmoid":
        jbij, tbij = jb.SigmoidT(), tb.SigmoidT()
        x = 4 * n01(B, 1)
        y = np.concatenate([[[0.0], [1.0]], rng.uniform(0, 1, (B - 2, 1))]).astype(np.float32)
    elif name.startswith("bn"):
        jbij, tbij = jb.BatchNormFlow(dim=2), tb.BatchNormFlow(dim=2)
        x, y = n01(B, 2), 3 + 2 * n01(B, 2)
    elif name == "cond_affine":
        kw = dict(context_dim=3, hidden=(8, 8))
        jbij, tbij = jb.ConditionalAffineT(**kw), tb.ConditionalAffineT(**kw)
        x, y, ctx = n01(B, 1), n01(B, 1), 3 * n01(B, 3)  # large ctx hits the log-scale clip
    elif name in ("rq_spline", "linear_spline"):
        cls = "SplineT" if name == "rq_spline" else "LinearRationalSplineT"
        jbij, tbij = getattr(jb, cls)(dim=2), getattr(tb, cls)(dim=2)
        x = rng.uniform(-4, 4, (B, 2)).astype(np.float32)  # both tails and the inside
        y = rng.uniform(-4, 4, (B, 2)).astype(np.float32)
    elif name == "chain":
        bijs = lambda m: (m.BatchNormFlow(dim=1), m.ExpT(), m.AffineT(0.5, 2.0))  # noqa: E731
        jbij, tbij = jb.Chain(bijs(jb)), tb.Chain(bijs(tb))
        x, y = n01(B, 1), np.exp(n01(B, 1)) * 2 + 0.5
    else:
        raise KeyError(name)
    params, state = jax.device_get(jbij.init(jax.random.PRNGKey(0)))
    params = _redraw(params, rng, 0.7)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32), state)
    return jbij, tbij, params, state, x, y, ctx


CASES = ["affine", "exp", "sigmoid", "bn_eval", "bn_train", "cond_affine",
         "rq_spline", "linear_spline", "chain"]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("name", CASES)
def test_bijector_matches_jax(name, direction):
    rng = np.random.default_rng(CASES.index(name))
    jbij, tbij, params, state, x, y, ctx = _case(name, rng)
    train = name == "bn_train"
    v = x if direction == "forward" else y
    tol = 5e-5 if (name, direction) == ("linear_spline", "inverse") else TOL
    jout, jld, jstate = getattr(jbij, direction)(
        params, jnp.asarray(v), None if ctx is None else jnp.asarray(ctx), state=state, train=train)
    tout, tld, tstate = getattr(tbij, direction)(
        _to_torch(params), torch.from_numpy(v), None if ctx is None else torch.from_numpy(ctx),
        state=_to_torch(state), train=train)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=tol, atol=tol)
    assert tld.shape == (B,)
    flat_j = jax.tree_util.tree_leaves(_np_tree(jstate))
    flat_t = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tstate))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["rq_spline", "linear_spline", "cond_affine", "chain"])
def test_bijector_round_trip(name):
    rng = np.random.default_rng(7)
    _, tbij, params, state, x, _, ctx = _case(name, rng)
    p, s = _to_torch(params), _to_torch(state)
    c = None if ctx is None else torch.from_numpy(ctx)
    y, ld_f, _ = tbij.forward(p, torch.from_numpy(x), c, state=s)
    x2, ld_i, _ = tbij.inverse(p, y, c, state=s)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=1e-4)


def test_distributions_log_prob_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 2)).astype(np.float32)
    np.testing.assert_allclose(
        td.Normal(0.5, 2.0, (2,)).log_prob(torch.from_numpy(x)).numpy(),
        np.asarray(jd.Normal(0.5, 2.0, (2,)).log_prob(jnp.asarray(x))), rtol=TOL, atol=TOL)
    g = rng.gumbel(size=(B, 10)).astype(np.float32)
    np.testing.assert_allclose(
        td.Gumbel().log_prob(torch.from_numpy(g)).numpy(),
        np.asarray(jd.Gumbel().log_prob(jnp.asarray(g))), rtol=TOL, atol=TOL)
    logits = rng.normal(size=(B, 10)).astype(np.float32)
    value = rng.integers(0, 10, B)
    for lg in (logits, logits[0]):
        np.testing.assert_allclose(
            td.Categorical(10).log_prob(torch.from_numpy(lg), torch.from_numpy(value)).numpy(),
            np.asarray(jd.Categorical(10).log_prob(jnp.asarray(lg), jnp.asarray(value))),
            rtol=TOL, atol=TOL)


def test_categorical_sample_with_injected_gumbels_matches_jax():
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(9).normal(size=10).astype(np.float32)
    ref = jd.Categorical(10).sample(key, jnp.asarray(logits), B)
    g = np.array(jax.random.gumbel(key, (B, 10)))
    out = td.Categorical(10).sample(None, torch.from_numpy(logits), B, gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_flow_dist_log_prob_and_sample_match_jax():
    rng = np.random.default_rng(10)
    jf = jd.FlowDist.create(jd.Normal(), [jb.SplineT(dim=1), jb.AffineT(-1.0, 3.0)])
    tf = td.FlowDist.create(td.Normal(), [tb.SplineT(dim=1), tb.AffineT(-1.0, 3.0)])
    params, state = jax.device_get(jf.init(jax.random.PRNGKey(1)))
    params = _redraw(params, rng, 0.7)
    x = rng.normal(0, 3, (B, 1)).astype(np.float32)
    jlp, _ = jf.log_prob(params, jnp.asarray(x), state=state)
    tlp, _ = tf.log_prob(_to_torch(params), torch.from_numpy(x), state=_to_torch(state))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)
    key = jax.random.PRNGKey(4)
    jx, _ = jf.sample(params, key, B, state=state)
    u = np.array(jax.random.normal(key, (B, 1)))
    tx, _ = tf.sample(_to_torch(params), None, B, state=_to_torch(state), noise=torch.from_numpy(u))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)


def test_samples_follow_the_generator():
    a = td.Normal().sample(torch.Generator().manual_seed(5), 4)
    b = td.Normal().sample(torch.Generator().manual_seed(5), 4)
    assert torch.equal(a, b) and a.shape == (4, 1)
    g = td.Gumbel().sample(torch.Generator().manual_seed(6), (4, 10))
    assert torch.isfinite(g).all()
