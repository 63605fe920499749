"""The port's DeepSCM VAE baseline (``imagecfgen_torch/models/vae.py``,
``train/vae_trainer.py``) against the JAX package's, with the JAX params
carried across by ``core.convert.vae_params_from_jax``.

- the full-width MNIST encoder (mean and log-variance) and decoder, f32, with
  weights redrawn at N(0, 1/sqrt(fan_in)) so activations stay O(1): 2e-4
  absolute and 1e-4 relative, the BiGAN tests' tolerance (a five-conv stack
  summed in f32 in another order);
- the encoder's trunk takes ``fused_encoder_forward`` when no gradient is
  recorded and its ``PlanSequential`` when one is, with the same result;
- ``encode_sample`` and ``elbo`` with the JAX package's normals injected (the
  draws of ``jax.random.normal`` under the same key): 1e-4 relative;
- one ``VAETrainer.train_step`` at ``tests/test_trainers.py::tiny_vae_config``'s
  sizes, weights redrawn as above: the loss to 1e-5 relative, every gradient
  to 1e-4 relative plus 1e-5 of the tensor's largest entry, and the
  parameters after the Adam step as ``tests/test_torch_gan_trainer.py`` holds
  them (Adam's first update is ``lr * g / |g|``: 1e-5 relative plus
  ``0.02 * lr``, one element in a thousand up to ``2 * lr``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.train import vae_trainer as jvt
from imagecfgen_torch.core.convert import vae_params_from_jax, vae_state_dict_from_jax
from imagecfgen_torch.models import vae as tvae
from imagecfgen_torch.models.bigan import mnist_bigan_config
from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

TOL = dict(rtol=1e-4, atol=2e-4)
LR = 1e-4


def attrs_np(b, rng):
    a = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]}
    for k in ("thickness", "intensity", "slant"):
        a[k] = rng.uniform(-1, 1, b).astype(np.float32)
    return a


def redraw(params, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            std = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "embed" in name:
            std = 1.0
        else:
            std = 0.1
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def jax_params(jmodel, x, a, seed=0, fan_in=True):
    """``{"encoder", "decoder"}`` params of the JAX VAE (redrawn O(1) when
    ``fan_in``), as numpy."""
    key = jax.random.PRNGKey(seed)
    z = jnp.zeros((x.shape[0], 1, 1, jmodel.cfg.latent_dim))
    p = jax.jit(lambda x, a: {
        "encoder": jmodel.encoder.init({"params": key}, x, a)["params"],
        "decoder": jmodel.decoder.init({"params": key}, z, a)["params"]})(jnp.asarray(x), a)
    return redraw(p, np.random.default_rng(seed)) if fan_in else jax.device_get(p)


@functools.lru_cache(maxsize=None)
def full_pair(seed=0, b=4):
    rng = np.random.default_rng(seed + 100)
    jmodel = jvae.ConditionalVAE(jvae.mnist_vae_config())
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    a = attrs_np(b, rng)
    params = jax_params(jmodel, x, a, seed)
    tmodel = vae_params_from_jax(params, tvae.mnist_vae_config(), "cpu").eval()
    return jmodel, params, tmodel, x, a, {k: torch.from_numpy(v) for k, v in a.items()}


def test_configs_are_the_jax_packages():
    for name in ("mnist_vae_config", "audio_mnist_vae_config"):
        j, t = getattr(jvae, name)(), getattr(tvae, name)()
        for field in ("enc_plan", "gen_plan", "vae_trunk_tail", "init_std", "latent_dim",
                      "embed_dim", "embed_hw", "image_size", "gen_input"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert mnist_bigan_config().vae_trunk_tail == (("lrelu", 0.2),)


def test_converter_covers_every_parameter():
    _, params, tmodel, *_ = full_pair()
    sd = vae_state_dict_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_jax


def test_full_width_encoder_and_decoder_match_jax():
    jmodel, params, tmodel, x, a, ta = full_pair()
    want_mean, want_lv = jmodel.encoder.apply({"params": params["encoder"]}, jnp.asarray(x), a)
    with torch.no_grad():
        mean, log_var = tmodel.encoder(torch.from_numpy(x), ta)
    assert tuple(mean.shape) == want_mean.shape == (4, 1, 1, 512)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(log_var.numpy(), np.asarray(want_lv), **TOL)

    z = np.random.default_rng(5).normal(0, 1, (4, 1, 1, 512)).astype(np.float32)
    want = jmodel.decoder.apply({"params": params["decoder"]}, jnp.asarray(z), a)
    with torch.no_grad():
        got = tmodel.decoder(torch.from_numpy(z), ta)
    assert tuple(got.shape) == want.shape == (4, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_trunk_route_follows_the_encoder_rule(monkeypatch):
    """No gradient recorded: the trunk goes through ``fused_encoder_forward``
    (its plain version on the CPU) and then the tail's LeakyReLU; a gradient
    asked for: the ``PlanSequential``. Both compute the same features."""
    _, _, tmodel, x, _, ta = full_pair(seed=1)
    calls = []
    real = tvae.fused_encoder_forward

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tvae, "fused_encoder_forward", counting)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        served = tmodel.encoder.features(xt, ta)
    assert len(calls) == 1
    trained = tmodel.encoder.features(xt, ta)
    assert len(calls) == 1 and trained.requires_grad
    np.testing.assert_allclose(served.numpy(), trained.detach().numpy(), **TOL)
    assert (served.numpy() < 0).any()  # the tail's LeakyReLU passes negatives at 0.2


def test_encode_sample_and_elbo_with_injected_noise_match_jax():
    jmodel, params, tmodel, x, a, ta = full_pair(seed=2)
    key = jax.random.PRNGKey(7)
    mean, _ = jmodel.encoder.apply({"params": params["encoder"]}, jnp.asarray(x), a)
    eps = np.array(jax.random.normal(key, mean.shape))
    want = jmodel.encode_sample(params["encoder"], key, jnp.asarray(x), a)
    with torch.no_grad():
        got = tmodel.encode_sample(torch.from_numpy(x), ta, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    for s, kl in ((2, 1.0), (3, 10.0)):
        eps = np.array(jax.random.normal(key, (4, s) + mean.shape[1:], mean.dtype))
        want = float(jmodel.elbo(params, key, jnp.asarray(x), a, num_samples=s, kl_weight=kl))
        with torch.no_grad():
            got = float(tmodel.elbo(torch.from_numpy(x), ta, num_samples=s, kl_weight=kl,
                                    eps=torch.from_numpy(eps)))
        assert np.isfinite(want)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_elbo_draws_its_noise_from_the_generator():
    _, _, tmodel, x, _, ta = full_pair(seed=3, b=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a1 = tmodel.elbo(xt, ta, rng=torch.Generator().manual_seed(4))
        a2 = tmodel.elbo(xt, ta, rng=torch.Generator().manual_seed(4))
        b1 = tmodel.elbo(xt, ta, rng=torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2) and not torch.equal(a1, b1)


# ------------------------------------------------------------ training


def tiny_vae_config(mod):
    """``tests/test_trainers.py::tiny_vae_config`` built from either
    package's ``mnist_bigan_config``."""
    lr = ("lrelu", 0.2)
    return dataclasses.replace(
        mod.mnist_bigan_config(latent_dim=16), latent_dim=16, embed_dim=16, embed_hw=(4, 4),
        enc_plan=(("conv", 8, 3, 2, 1), lr, ("conv", 16, 4, 2, 1), lr, ("conv", 16, 4, 2, 1), lr,
                  ("conv", 16, 4, 2, 1), lr, ("conv", 16, 1, 2, 0)),
        gen_plan=(("convT", 16, 3, 1, 0), lr, ("convT", 16, 3, 2, 0), lr, ("convT", 8, 3, 2, 1), lr,
                  ("convT", 8, 3, 2, 1), lr, ("convT", 1, 4, 1, 0), ("tanh",)),
        init_std=1e-2)


def test_tiny_config_is_the_jax_tests():
    from test_trainers import tiny_vae_config as jax_tests_config

    want = jax_tests_config()
    got = tiny_vae_config(jvae)
    for field in ("enc_plan", "gen_plan", "latent_dim", "embed_dim", "embed_hw", "init_std"):
        assert getattr(got, field) == getattr(want, field), field


def test_one_train_step_follows_jax():
    b, s = 8, 4
    tcfg = dict(batch_size=b, num_samples_per_step=s, kl_weight=10.0, learning_rate=LR)
    jtr = jvt.VAETrainer(jvae.ConditionalVAE(tiny_vae_config(jvae)), jvt.VAETrainConfig(**tcfg))
    st = jtr.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # O(1) weights: at the config's N(0, 0.01) the first layers' gradients
    # are ~1e-11, sums that cancel down to their rounding
    params = redraw(st.params, rng)
    st = st.replace(params=params, opt=jtr.tx.init(params))
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    a = attrs_np(b, rng)
    batch = {"image": jnp.asarray(x), "attrs": {k: jnp.asarray(v) for k, v in a.items()}}

    # the noise the JAX step draws: split(state.rng)[1] -> normal (B, S, 1, 1, latent)
    key = jax.random.split(st.rng)[1]
    eps = np.array(jax.random.normal(key, (b, s, 1, 1, 16), jnp.float32))

    def loss_fn(p):
        return -jtr.model.elbo(p, key, batch["image"], batch["attrs"], num_samples=s,
                               kl_weight=10.0, train=True)

    want_grads = vae_state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss_fn))(st.params)))
    new_st, metrics = jax.jit(jtr.train_step)(st, batch)

    tmodel = vae_params_from_jax(jax.device_get(st.params), tiny_vae_config(tvae), "cpu")
    ttr = VAETrainer(tmodel, VAETrainConfig(**tcfg), "cpu")
    out = ttr.train_step({"image": torch.from_numpy(x), "attrs": {k: torch.from_numpy(v) for k, v in a.items()}},
                         eps=torch.from_numpy(eps))
    np.testing.assert_allclose(out["neg_elbo"].item(), float(metrics["neg_elbo"]), rtol=1e-5)
    assert ttr.step == 1 and ttr.opt.count == 1

    named = dict(tmodel.named_parameters())
    assert set(named) == set(want_grads)
    for name, g in want_grads.items():
        got = named[name].grad.numpy()
        np.testing.assert_allclose(got, g.numpy(), rtol=1e-4, atol=1e-5 * float(g.abs().max()),
                                   err_msg=f"grad {name}")

    want_params = vae_state_dict_from_jax(jax.device_get(new_st.params))
    for name, want in want_params.items():
        have, want = named[name].detach().numpy(), want.numpy()
        err = np.abs(have - want)
        tight = err <= 0.02 * LR + 1e-5 * np.abs(want)
        assert tight.mean() >= 0.999, f"{name}: {(~tight).sum()} of {tight.size} elements off"
        assert err.max() <= 2 * LR, f"{name}: off by {err.max()}"


def test_fit_epoch_lowers_the_loss_and_state_round_trips():
    """As ``tests/test_trainers.py``'s VAE test: a few epochs of the tiny
    config lower -ELBO; ``state_dict`` loads into a fresh trainer whose next
    step is the same."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (32, 28, 28, 1)).astype(np.float32)
    a = attrs_np(32, rng)
    gen = torch.Generator().manual_seed(0)
    tr = VAETrainer(tvae.ConditionalVAE(tiny_vae_config(tvae), "cpu", gen),
                    VAETrainConfig(batch_size=8, kl_weight=1.0), "cpu", seed=1)
    data = tr.upload_dataset(x, a)
    losses = [tr.fit_epoch(data)["neg_elbo"] for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert tr.step == 6 * 4

    twin = VAETrainer(tvae.ConditionalVAE(tiny_vae_config(tvae), "cpu"),
                      VAETrainConfig(batch_size=8, kl_weight=1.0), "cpu", seed=9)
    twin.load_state_dict(tr.state_dict())
    one = tr.fit_epoch(data)["neg_elbo"]
    assert twin.fit_epoch(data)["neg_elbo"] == one


def test_run_epoch_refuses_zero_batches():
    tr = VAETrainer(tvae.ConditionalVAE(tiny_vae_config(tvae), "cpu"), VAETrainConfig(batch_size=8), "cpu")
    empty = {"image": np.zeros((0, 8, 28, 28, 1), np.float32),
             "attrs": {k: np.zeros((0, 8) + v.shape[1:], np.float32)
                       for k, v in attrs_np(1, np.random.default_rng(0)).items()}}
    with pytest.raises(ValueError, match="zero batches"):
        tr.run_epoch(empty)
