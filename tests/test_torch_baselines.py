"""The port's pixel baselines (``imagecfgen_torch/cf/baselines.py``: Wachter
counterfactuals, CEM pertinent negatives and positives) against the JAX
package's (``imagecfgen_tpu/cf/baselines.py``).

- Wachter and CEM over 10 steps and the full c ladder on a narrow MNIST
  classifier (weights N(0, 1/sqrt(fan_in)), carried across by
  ``core.convert``): the images within 1e-5 absolute (a few gradient steps of
  0.05 through a four-conv classifier summed in another order) and the
  ``ok`` masks equal;
- the subgradient of |.| at 0: Wachter starts at ``x``, where every pixel's
  L1 term has a zero argument. JAX's gradient there is +1 and moves every
  pixel by ``-lr`` on step 1. On a linear classifier built so that this
  move, and only this move, flips the label on step 1, the port follows the
  JAX trajectory step by step from step 1; with ``torch.abs`` in place of the
  port's ``l1_abs`` it does not flip, and the result differs;
- an unflippable classifier: every ``ok`` False and the input returned.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_explain import narrow_classifier_config
from test_torch_train_layers import redraw

from imagecfgen_tpu.cf.baselines import PixelBaselineExplainers as JBaselines
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_torch.cf import baselines as tbaselines
from imagecfgen_torch.cf.baselines import PixelBaselineExplainers
from imagecfgen_torch.core.convert import classifier_params_from_jax
from imagecfgen_torch.models import classifier as tclf

TOL = 1e-5


@pytest.fixture(scope="module")
def mnist():
    rng = np.random.default_rng(0)
    x = np.clip(rng.normal(-0.5, 0.6, (3, 28, 28, 1)), -1, 1).astype(np.float32)
    jc = jclf.CNNClassifier(narrow_classifier_config(jclf))
    params = redraw(jc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"], rng)
    tc = classifier_params_from_jax(params, narrow_classifier_config(tclf), "cpu")
    return jax.jit(lambda im: jc.apply({"params": params}, im)), tc, x


def close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_counterfactual_matches_jax(mnist):
    jc, tc, x = mnist
    want_cf, want_ok = JBaselines(jc, steps=10).counterfactual(jnp.asarray(x))
    with torch.no_grad():
        base = tc(torch.from_numpy(x))
    got_cf, got_ok = PixelBaselineExplainers(tc, steps=10).counterfactual(torch.from_numpy(x))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.asarray(want_ok).any()
    close(got_cf, want_cf)
    assert float(got_cf.min()) >= -1.0 and float(got_cf.max()) <= 1.0
    with torch.no_grad():
        flipped = tc(got_cf).argmax(-1) != base.argmax(-1)
    np.testing.assert_array_equal(flipped.numpy(), got_ok.numpy())


def test_contrastive_matches_jax(mnist):
    jc, tc, x = mnist
    want = JBaselines(jc, steps=10).contrastive(jnp.asarray(x))
    got = PixelBaselineExplainers(tc, steps=10).contrastive(torch.from_numpy(x))
    for name, g, w in zip(("pn", "pn_ok", "pp", "pp_ok"), got, want):
        if name.endswith("ok"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            close(g, w)
    pn, pn_ok, pp, pp_ok = got
    assert np.asarray(want[1]).any() and np.asarray(want[3]).any()
    assert float(pn.min()) >= -1.0 and float(pn.max()) <= 1.0
    xt = torch.from_numpy(x)
    assert bool((pp.abs() <= xt.abs()).all()) and bool((pp * xt >= 0).all())


# ------------------------------------------- the subgradient of |.| at 0


def linear_case():
    """A 3-class linear classifier on 8x8 images: class 0 scores the pixel
    sum, class 1 scores 0, class 2 never wins. The images' sums are 0.5 and
    1.0, so class 0 holds by that much; one Wachter step at c = 0.1 lowers
    every pixel by lr * (0.1 + 1) when |.|'s gradient at 0 is +1 (the sum
    drops by 3.52: flipped) and by lr * 0.1 when it is 0 (by 0.32: not)."""
    w = np.zeros((64, 3), np.float32)
    w[:, 0], w[:, 2] = 1.0, -10.0
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (2, 64)).astype(np.float32)
    x += (np.array([[0.5], [1.0]], np.float32) - x.sum(axis=1, keepdims=True)) / 64
    x = x.reshape(2, 8, 8, 1)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    return (lambda im: im.reshape(im.shape[0], -1) @ jw), (lambda im: im.reshape(im.shape[0], -1) @ tw), x


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_wachter_follows_jax_from_step_one(steps):
    jfn, tfn, x = linear_case()
    want_cf, want_ok = JBaselines(jfn, steps=steps, c_values=(0.1,)).counterfactual(jnp.asarray(x))
    got_cf, got_ok = PixelBaselineExplainers(tfn, steps=steps, c_values=(0.1,)).counterfactual(
        torch.from_numpy(x))
    assert np.asarray(want_ok).all()  # flipped on step 1 already
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    close(got_cf, want_cf)
    if steps == 1:  # the step-1 iterate: every pixel moved by -lr * (0.1 + 1)
        np.testing.assert_allclose(got_cf.numpy(), x - 0.05 * 1.1, rtol=0, atol=1e-6)


def test_wachter_with_torch_abs_would_not_follow_jax(monkeypatch):
    jfn, tfn, x = linear_case()
    want_cf, want_ok = JBaselines(jfn, steps=1, c_values=(0.1,)).counterfactual(jnp.asarray(x))
    monkeypatch.setattr(tbaselines, "l1_abs", torch.abs)
    got_cf, got_ok = PixelBaselineExplainers(tfn, steps=1, c_values=(0.1,)).counterfactual(
        torch.from_numpy(x))
    assert not got_ok.any() and np.asarray(want_ok).all()
    assert np.abs(got_cf.numpy() - np.asarray(want_cf)).max() > 0.05


def test_hinges_take_half_the_gradient_at_a_tie():
    """``jnp.maximum(v, 0)``'s gradient at v = 0 is 0.5; ``torch.relu``'s
    and ``clamp``'s are 0."""
    v = torch.zeros(3, requires_grad=True)
    tbaselines._hinge(v).sum().backward()
    assert v.grad.tolist() == [0.5, 0.5, 0.5]
    assert float(jax.grad(lambda t: jnp.maximum(t, 0.0))(0.0)) == 0.5


def test_unflippable_input_reports_failure():
    def jconst(im):
        return jnp.zeros((im.shape[0], 3)) + jnp.asarray([1.0, 0.0, 0.0]) + 0.0 * im.sum()

    def tconst(im):
        return torch.zeros((im.shape[0], 3)) + torch.tensor([1.0, 0.0, 0.0]) + 0.0 * im.sum()

    x = np.random.default_rng(2).uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    jb, tb = JBaselines(jconst, steps=5), PixelBaselineExplainers(tconst, steps=5)
    want_cf, want_ok = jb.counterfactual(jnp.asarray(x))
    got_cf, got_ok = tb.counterfactual(torch.from_numpy(x))
    assert not got_ok.any() and not np.asarray(want_ok).any()
    np.testing.assert_array_equal(got_cf.numpy(), x)
    np.testing.assert_array_equal(np.asarray(want_cf), x)
    pn, pn_ok, pp, pp_ok = tb.contrastive(torch.from_numpy(x))
    want = jb.contrastive(jnp.asarray(x))
    assert not pn_ok.any() and not np.asarray(want[1]).any()
    np.testing.assert_array_equal(pn.numpy(), x)
    np.testing.assert_array_equal(pp_ok.numpy(), np.asarray(want[3]))
    close(pp, want[2])


def test_ladder_folds_lane_major():
    tb = PixelBaselineExplainers(lambda im: im.reshape(im.shape[0], -1)[:, :3], c_values=(1.0, 2.0))
    x = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 2, 2, 1)
    orig, c_rows, xs = tb._ladder(x)
    assert c_rows.tolist() == [1.0, 1.0, 2.0, 2.0]
    assert torch.equal(xs, torch.cat([x, x])) and torch.equal(orig, torch.cat([orig[:2], orig[:2]]))
    out, ok = tb._pick(torch.stack([x[0], x[1], -x[0], -x[1]]), torch.tensor([3.0, float("inf"), 1.0, 5.0]), 2)
    assert torch.equal(out, torch.stack([-x[0], -x[1]])) and ok.tolist() == [True, True]


def test_dataclass_fields_are_the_jax_packages():
    jf = {f.name: f.default for f in dataclasses.fields(JBaselines)}
    tf = {f.name: f.default for f in dataclasses.fields(PixelBaselineExplainers)}
    assert jf.keys() == tf.keys()
    assert {k: v for k, v in jf.items() if k != "classify_fn"} == {k: v for k, v in tf.items() if k != "classify_fn"}
