"""The port's ``ConvAutoEncoder`` against the JAX package's on the CPU: the
same outputs on converted weights (eval mode), and the same ``mse`` step of
``SupervisedTrainer``.

Tolerances: outputs 1e-5 relative and 1e-6 absolute (three convs, two dense
layers and three transposed convs summed in float32 in another order, tanh
at the end); the loss 1e-5 relative; after one Adam(1e-4) step the
parameters as in ``test_torch_clf_trainer.py`` (1e-5 relative plus 0.02·lr
for 99.9 % of a tensor, 2·lr for all of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_clf_trainer import redraw

from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.train import clf_trainer as jct
from imagecfgen_torch.core.convert import autoencoder_params_from_jax, plan_state_dict_from_jax
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

LR, B, LATENT = 1e-4, 4, 16


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jm = jclf.ConvAutoEncoder(jclf.AutoEncoderConfig(latent_dim=LATENT))
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    params = redraw(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = autoencoder_params_from_jax(params, tclf.AutoEncoderConfig(latent_dim=LATENT), "cpu")
    return jm, params, tm, rng


def test_forward_matches_jax(pair):
    jm, params, tm, rng = pair
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        have = tm(torch.from_numpy(x))
    assert tuple(have.shape) == want.shape == (B, 28, 28, 1) and have.dtype == torch.float32
    np.testing.assert_allclose(have.numpy(), want, rtol=1e-5, atol=1e-6)
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(
        [f"encoder.{k}" for k in plan_state_dict_from_jax(params["encoder"])]
        + [f"decoder.{k}" for k in plan_state_dict_from_jax(params["decoder"])])


def test_one_mse_step_matches_jax(pair):
    jm, params, _, rng = pair
    tm = autoencoder_params_from_jax(params, tclf.AutoEncoderConfig(latent_dim=LATENT), "cpu")
    jtr = jct.SupervisedTrainer(jm, jct.SupervisedTrainConfig(batch_size=B, loss="mse"))
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    st = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    st = st.replace(params=params, opt=jtr.tx.init(params))
    tr = SupervisedTrainer(tm, SupervisedTrainConfig(batch_size=B, loss="mse"), device="cpu")
    st, ref = jtr.train_step(st, {"x": jnp.asarray(x), "y": jnp.asarray(x)})
    got = tr.train_step({"x": torch.from_numpy(x), "y": torch.from_numpy(x)})
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5)
    new = jax.device_get(st.params)
    for part in ("encoder", "decoder"):
        want_sd = plan_state_dict_from_jax(new[part])
        for name, p in getattr(tm, part).named_parameters():
            have, want = p.detach().numpy(), want_sd[name].numpy()
            err = np.abs(have - want)
            tight = err <= 0.02 * LR + 1e-5 * np.abs(want)
            assert tight.mean() >= 0.999, f"{part}.{name}: {(~tight).sum()} of {tight.size} elements off"
            assert err.max() <= 2 * LR, f"{part}.{name}: off by {err.max()}"
    assert tr.state_dict()["opt"]["count"] == 1


def test_autoencoder_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclf.ConvAutoEncoder(tclf.AutoEncoderConfig())
    out = tclf.ConvAutoEncoder(tclf.AutoEncoderConfig(), "cpu")(torch.zeros(2, 28, 28, 1))
    assert tuple(out.shape) == (2, 28, 28, 1)
