"""The port's counterfactual explainers (``imagecfgen_torch/cf/explain.py``)
against the JAX package's (``imagecfgen_tpu/cf/explain.py``), on a narrow
MNIST BiGAN (every width an eighth, latent 32) and a narrow MNIST classifier,
weights drawn with numpy at N(0, 1/sqrt(fan_in)) and carried across by
``core.convert``.

- ``DeepCounterfactualExplainer``'s sweep under the ``mixture``, ``mse`` and
  ``ssim`` metrics: the samples within 2e-4 absolute plus 1e-4 relative (the
  engine tests' image tolerance: a five-conv encoder and a five-deconv
  generator summed in another order), the metric values within 1e-5 plus
  1e-4 relative, the flipped masks equal; ``explain``'s sorted subset and its
  no-flip branch (every candidate, in sweep order);
- ``HingeLossCFExplainer`` with the JAX package's initial parameters
  injected (the draws its ``_optimize`` makes from the key), ``train_z``
  both ways and ``target_class`` both None and an int, 5 Adam steps at lr
  0.1: the counterfactual within 1e-4·max(1, max|x|) (Adam's first update
  is ``lr * sign(g)`` for both; later ones follow smoothly);
- the explainers encode once, through ``fused_encoder_forward``, and leave
  no ``.grad`` on the models' parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layers import narrow_config, narrow_plan, redraw

from imagecfgen_tpu.cf import explain as jexplain
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_torch.cf import explain as texplain
from imagecfgen_torch.core.convert import bigan_params_from_jax, classifier_params_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf

IMG = dict(atol=2e-4, rtol=1e-4)
IGNORE = ("slant", "intensity")


def narrow_classifier_config(mod):
    full = mod.mnist_classifier_config()
    return dataclasses.replace(full, plan=narrow_plan(full.plan, 8, keep_last=False))


def make_models(seed: int = 0):
    """JAX (E, G, classifier) functions and the port's, on the same
    weights, with one image and its scaled attributes from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 28, 28, 1)).astype(np.float32)
    a = {"digit": np.eye(10, dtype=np.float32)[[rng.integers(0, 10)]]}
    a.update({k: rng.uniform(-1, 1, 1).astype(np.float32) for k in ("thickness", "intensity", "slant")})
    key = jax.random.PRNGKey(seed)
    jm = jbigan.BiGAN(narrow_config(jbigan, "mnist"))
    pE = redraw(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"], rng)
    pG = redraw(jm.generator.init({"params": key}, jnp.zeros((1, 1, 1, 32)), a)["params"], rng)
    jc = jclf.CNNClassifier(narrow_classifier_config(jclf))
    pC = redraw(jc.init({"params": key}, jnp.asarray(x))["params"], rng)
    tm = bigan_params_from_jax(pE, pG, narrow_config(tbigan, "mnist"), "cpu").eval()
    tc = classifier_params_from_jax(pC, narrow_classifier_config(tclf), "cpu")
    jfns = (jax.jit(lambda xx, aa: jm.encoder.apply({"params": pE}, xx, aa)),
            jax.jit(lambda zz, aa: jm.generator.apply({"params": pG}, zz, aa)),
            jax.jit(lambda im: jc.apply({"params": pC}, im)))
    tfns = (lambda xx, aa: tm.encoder(xx, aa), lambda zz, aa: tm.generator(zz, aa), tc)
    return jfns, tfns, (tm, tc), x, a


@pytest.fixture(scope="module")
def models():
    return make_models()


def as_jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def as_torch(a):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}


def boosted(clf, target, boost, mod):
    """``clf`` with ``boost`` added to the target's logit (either package)."""
    onehot = np.eye(10, dtype=np.float32)[target] * boost
    if mod is jnp:
        return lambda im: clf(im) + jnp.asarray(onehot)
    return lambda im: clf(im) + torch.from_numpy(onehot)


def half_flipping_boost(jfns, x, a, original, target, points):
    """A boost of the target's logit that flips about half the sweep's
    samples in the JAX package, halfway between two neighbouring margins
    (so rounding cannot move a sample across)."""
    E, G, C = jfns
    z = E(jnp.asarray(x), as_jax(a))
    probs = np.linspace(0, 1, points, dtype=np.float32)[:, None]
    eye = np.eye(10, dtype=np.float32)
    cf = {k: jnp.repeat(jnp.asarray(v), points, axis=0) for k, v in a.items() if k != "digit"}
    cf["digit"] = jnp.asarray((1 - probs) * eye[original] + probs * eye[target])
    logits = np.asarray(C(G(jnp.repeat(z, points, axis=0), cf)))
    margin = np.sort(logits[:, target] - np.delete(logits, target, axis=1).max(axis=1))
    k = points // 2
    return -float(margin[k] + margin[k + 1]) / 2


@pytest.mark.parametrize("metric", ["mixture", "mse", "ssim"])
def test_sweep_matches_jax(models, metric):
    jfns, tfns, _, x, a = models
    original = int(np.argmax(np.asarray(jfns[2](jnp.asarray(x)))))
    target = (original + 3) % 10
    boost = half_flipping_boost(jfns, x, a, original, target, 20)
    jd = jexplain.DeepCounterfactualExplainer(jfns[0], jfns[1], boosted(jfns[2], target, boost, jnp), "digit")
    td = texplain.DeepCounterfactualExplainer(tfns[0], tfns[1], boosted(tfns[2], target, boost, torch), "digit")
    js, jv, jf = map(np.asarray, jd._sweep(jnp.asarray(x), as_jax(a), original, target, 20, metric))
    ts, tv, tf = (t.numpy() for t in td.sweep(torch.from_numpy(x), as_torch(a), original, target, 20, metric))
    assert ts.shape == js.shape == (20, 28, 28, 1)
    np.testing.assert_allclose(ts, js, **IMG)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-4)
    assert 0 < jf.sum() < 20
    np.testing.assert_array_equal(tf, jf)

    # explain: the flipped subset, sorted by the metric
    want_s, want_v = jd.explain(jnp.asarray(x), as_jax(a), target, sample_points=20, metric=metric)
    got_s, got_v = td.explain(torch.from_numpy(x), as_torch(a), target, sample_points=20, metric=metric)
    assert len(got_v) == len(want_v) == jf.sum()
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), want_s, **IMG)
    assert np.all(np.diff(got_v.numpy()) >= 0)


def test_explain_without_a_flip_returns_every_candidate(models):
    jfns, tfns, _, x, a = models
    target = (int(np.argmax(np.asarray(jfns[2](jnp.asarray(x))))) + 1) % 10
    jd = jexplain.DeepCounterfactualExplainer(jfns[0], jfns[1], boosted(jfns[2], target, -1e6, jnp), "digit")
    td = texplain.DeepCounterfactualExplainer(tfns[0], tfns[1], boosted(tfns[2], target, -1e6, torch), "digit")
    want_s, want_v = jd.explain(jnp.asarray(x), as_jax(a), target, sample_points=12, metric="mse")
    got_s, got_v = td.explain(torch.from_numpy(x), as_torch(a), target, sample_points=12, metric="mse")
    assert got_s.shape == want_s.shape == (12, 28, 28, 1)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-5, rtol=1e-4)  # sweep order, unsorted
    np.testing.assert_allclose(got_s.numpy(), want_s, **IMG)


def jax_initial_params(key, attrs, codes_shape, train_z):
    """The draws ``imagecfgen_tpu/cf/explain.py:121-132`` makes from ``key``."""
    k1, k2 = jax.random.split(key)
    params = {k: 0.01 * jax.random.normal(jax.random.fold_in(k1, i),
                                          (1, attrs[k].shape[1] if attrs[k].ndim > 1 else 1))
              for i, k in enumerate(sorted(attrs)) if k not in IGNORE}
    if train_z:
        params["z"] = jax.random.normal(k2, codes_shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("target", [None, 4])
@pytest.mark.parametrize("train_z", [True, False])
def test_hinge_explainer_matches_jax(models, train_z, target):
    jfns, tfns, _, x, a = models
    kw = dict(target_feature="digit", latent_dim=32, categorical_features=("digit",),
              features_to_ignore=IGNORE, c=10.0)
    jh = jexplain.HingeLossCFExplainer(*jfns, **kw)
    th = texplain.HingeLossCFExplainer(*tfns, **kw)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jh.explain(jnp.asarray(x), as_jax(a), target_class=target, train_z=train_z,
                                 steps=5, lr=0.1, rng=key))
    init = jax_initial_params(key, a, (1, 1, 1, 32), train_z)
    got = th.explain(torch.from_numpy(x), as_torch(a), target_class=target, train_z=train_z,
                     steps=5, lr=0.1, init=init).numpy()
    assert got.shape == want.shape == (1, 28, 28, 1)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    # the five steps moved the image away from the initial parameters' decode
    with torch.no_grad():
        attrs0, z0 = th._constrain(init, as_torch(a), train_z)
        start = tfns[1](z0 if train_z else tfns[0](torch.from_numpy(x), as_torch(a)), attrs0).numpy()
    assert np.abs(got - start).max() > 1e-3


def test_initial_parameters_come_from_the_generator(models):
    _, tfns, _, _, a = models
    th = texplain.HingeLossCFExplainer(*tfns, "digit", 32, ("digit",), IGNORE)
    codes = torch.zeros(1, 1, 1, 32)
    one = th.init_params(as_torch(a), codes, True, torch.Generator().manual_seed(3))
    two = th.init_params(as_torch(a), codes, True, torch.Generator().manual_seed(3))
    assert list(one) == ["digit", "thickness", "z"]
    assert one["digit"].shape == (1, 10) and one["thickness"].shape == (1, 1) and one["z"].shape == (1, 1, 1, 32)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert one["digit"].abs().max() < 0.1 and "z" not in th.init_params(as_torch(a), codes, False,
                                                                         torch.Generator())


def test_explainers_encode_through_the_kernel_and_leave_no_grad(models, monkeypatch):
    _, tfns, (tm, tc), x, a = models
    calls = []
    real = tbigan.fused_encoder_forward

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tbigan, "fused_encoder_forward", counting)
    xt, at = torch.from_numpy(x), as_torch(a)
    texplain.DeepCounterfactualExplainer(*tfns, "digit").explain(xt, at, 3, sample_points=8)
    assert len(calls) == 1
    th = texplain.HingeLossCFExplainer(*tfns, "digit", 32, ("digit",), IGNORE)
    out = th.explain(xt, at, target_class=3, steps=2, rng=torch.Generator().manual_seed(0))
    assert len(calls) == 2 and not out.requires_grad
    assert all(p.grad is None for m in (tm, tc) for p in m.parameters())


def test_l1_abs_has_jax_subgradient_at_zero():
    d = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    texplain.l1_abs(d).sum().backward()
    assert d.grad.tolist() == [-1.0, 1.0, 1.0]
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    np.testing.assert_array_equal(texplain.l1_abs(d).detach().numpy(), [2.0, 0.0, 3.0])
