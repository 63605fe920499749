"""The port's ``SupervisedTrainer`` against the JAX package's, on the CPU:
three Adam steps of each loss on a narrow AudioMNIST classifier (``width``
0.125: 512 -> dense 128 + LeakyReLU -> dense 10), whose head runs through
the dense->lrelu peephole (``fused_dense_lrelu`` and its hand-written
backward) in both packages.

Tolerance: the loss to 1e-5 relative. Adam(1e-4) moves an element by about
``lr`` a step and passes the relative error of its gradient on to it, so
after three steps parameters are held to 3e-5 relative plus ``0.06 * lr``
absolute; an element whose gradient is rounding noise (a sum that cancels) may
take the update's other sign, so up to one in a thousand of a tensor may miss
that, none by more than ``2 * lr`` a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.train import clf_trainer as jct
from imagecfgen_torch.core.convert import classifier_params_from_jax, plan_state_dict_from_jax
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import layers
from imagecfgen_torch.ops import fused_dense
from imagecfgen_torch.train.clf_trainer import (
    SupervisedTrainConfig,
    SupervisedTrainer,
    make_supervised_batches,
)

LR = 1e-4
B, STEPS = 4, 3


def redraw(params, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name else 0.1
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def targets(loss, rng):
    if loss == "ce":  # soft labels
        y = rng.random((B, 10)).astype(np.float32) ** 4
        return y / y.sum(1, keepdims=True)
    if loss == "bce":
        return rng.integers(0, 2, (B, 10)).astype(np.float32)
    return rng.normal(0, 1, (B, 10)).astype(np.float32)


def assert_params_close(module, params, steps):
    want_sd = plan_state_dict_from_jax(jax.device_get(params)["trunk"])
    for name, p in module.trunk.named_parameters():
        have, want = p.detach().numpy(), want_sd[name].numpy()
        err = np.abs(have - want)
        tight = err <= 0.02 * LR * steps + 1e-5 * steps * np.abs(want)
        assert tight.mean() >= 0.999, f"{name}: {(~tight).sum()} of {tight.size} elements off"
        assert err.max() <= 2 * LR * steps, f"{name}: off by {err.max()}"


@pytest.mark.parametrize("loss", ["ce", "bce", "mse"])
def test_three_steps_follow_jax(loss, monkeypatch):
    rng = np.random.default_rng({"ce": 0, "bce": 1, "mse": 2}[loss])
    jcfg = jclf.audio_mnist_classifier_config(10, width=0.125)
    tcfg = tclf.audio_mnist_classifier_config(10, width=0.125)
    jm = jclf.CNNClassifier(jcfg)
    jtr = jct.SupervisedTrainer(jm, jct.SupervisedTrainConfig(batch_size=B, loss=loss))
    x0 = rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32)
    st = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = redraw(st.params, rng)
    st = st.replace(params=params, opt=jtr.tx.init(params))

    tm = classifier_params_from_jax(params, tcfg, device="cpu")
    tr = SupervisedTrainer(tm, SupervisedTrainConfig(batch_size=B, loss=loss), device="cpu")
    heads = []
    real = fused_dense.fused_dense_lrelu
    monkeypatch.setattr(layers, "fused_dense_lrelu",
                        lambda x, w, b, s: (heads.append(tuple(x.shape)), real(x, w, b, s))[1])
    for step in range(STEPS):
        x = rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32)
        y = targets(loss, rng)
        st, ref = jtr.train_step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        got = tr.train_step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5,
                                   err_msg=f"step {step}")
        assert all(p.grad is not None for p in tm.parameters())
    assert heads == [(B, 512)] * STEPS  # the peephole, once a step
    assert tr.step == int(st.step) == STEPS
    assert_params_close(tm, st.params, STEPS)
    assert tr.state_dict()["opt"]["count"] == int(st.opt[0].count) == STEPS
    with torch.no_grad():
        logits = tr.predict(x)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jtr.predict(st, jnp.asarray(x))),
                               rtol=1e-3, atol=1e-4)


def small_trainer(loss="ce", seed=0):
    cfg = tclf.mnist_classifier_config()
    model = tclf.CNNClassifier(cfg, "cpu", torch.Generator().manual_seed(seed))
    return SupervisedTrainer(model, SupervisedTrainConfig(learning_rate=1e-3, batch_size=16, loss=loss),
                             device="cpu", seed=seed)


def test_epochs_learn_and_count():
    """A learnable toy task: the label is the brighter half of the image."""
    rng = np.random.default_rng(0)
    n = 16 * 6 + 3  # a ragged tail
    labels = rng.integers(0, 2, n)
    x = rng.normal(0, 0.1, (n, 28, 28, 1)).astype(np.float32)
    x[labels == 0, :14] += 1.0
    x[labels == 1, 14:] += 1.0
    y = np.eye(10, dtype=np.float32)[labels]
    tr = small_trainer()
    data = tr.upload_dataset(x, y)
    first = tr.fit_epoch(data)["loss"]
    for _ in range(4):
        last = tr.fit_epoch(data)["loss"]
    assert tr.step == 30 and np.isfinite(first) and last < 0.5 * first
    assert tr.accuracy(x, labels, batch_size=40) > 0.9
    out = tr.run_epoch(make_supervised_batches(rng, x, y, 16))
    assert tr.step == 36 and set(out) == {"loss"}
    with pytest.raises(ValueError, match="smaller than one batch"):
        tr.fit_epoch(tr.upload_dataset(x[:3], y[:3]))


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    model = tclf.CNNClassifier(tclf.mnist_classifier_config(), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SupervisedTrainer(model, SupervisedTrainConfig())
    assert SupervisedTrainer(model, SupervisedTrainConfig(), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unknown loss"):
        SupervisedTrainer(model, SupervisedTrainConfig(loss="hinge"), device="cpu")


def test_train_flag_reaches_the_plan():
    """``CNNClassifier.forward(train=True)`` runs its plan in train mode."""
    plan = (("flatten",), ("drop", 0.5), ("dense", 3))
    cfg = tclf.ClassifierConfig(plan=plan, image_size=(2, 2), n_classes=3)
    m = tclf.CNNClassifier(cfg, "cpu", torch.Generator().manual_seed(0))
    x = torch.ones(64, 2, 2, 1)
    with torch.no_grad():
        torch.manual_seed(1)
        a = m(x, train=True)
        torch.manual_seed(1)
        b = m(x, train=True)
        c = m(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c[0], c[1]) and not torch.equal(a[0], a[1])
