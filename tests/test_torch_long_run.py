"""The port's trainers against the JAX trainers over many steps, on the CPU
(where JAX computes in exact float32): the drift that one-step parity tests
cannot see. From the same parameters (redrawn O(1), as in the one-step
tests: at the configs' own init the first layers' gradients are rounding
noise) and the same injected noise, the GAN trainer at the batteries'
``d_updates_per_g_update=3`` for 12 steps (4 E+G and 24 D updates, three
times the one-step tests' four) and the VAE trainer for 64 steps must stay
within float32 rounding of JAX's.

Tolerances: every parameter within a thousandth of the way Adam can move it
(about ``LR`` an update) plus two float32 ulps of its value, so a wrong
moment, step count or schedule (an error of the order of the travel) fails.
As in the one-step tests, an element whose gradient is rounding noise (a sum
that cancels) may step the other way: up to one in a thousand of a tensor
may miss that, none by more than ``2 * LR`` an update. The metrics and D's
batch-norm statistics to 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_gan_trainer import B, LR, as_tree, batch_for, jax_state, port_trainer, to_torch
from test_torch_train_layers import MaskQueue, draw_masks
from test_torch_vae import attrs_np, redraw, tiny_vae_config

from imagecfgen_tpu.models import layers as jlayers
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.train import vae_trainer as jvt
from imagecfgen_torch.core.convert import gan_state_from_jax, vae_params_from_jax, vae_state_dict_from_jax
from imagecfgen_torch.models import vae as tvae
from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

GAN_STEPS, VAE_STEPS = 12, 64


def assert_follows(have, want, updates: int, what: str):
    err = np.abs(have - want)
    tight = err <= 1e-3 * LR * updates + 2.5e-7 * np.abs(want)
    assert tight.mean() >= 0.999, f"{what}: {(~tight).sum()} of {tight.size} elements off"
    assert err.max() <= 2 * LR * updates, f"{what}: off by {err.max()}"


def test_gan_trainer_follows_jax_for_12_steps(monkeypatch):
    kwargs = dict(d_updates_per_g_update=3)
    jtr, st, rng = jax_state("mnist", 0, kwargs)
    queue = MaskQueue()
    monkeypatch.setattr(jlayers, "channel_dropout", queue)
    tr = port_trainer("mnist", st, **kwargs)
    D = tr.model.discriminator
    for step in range(GAN_STEPS):
        batch = batch_for(tr.model.cfg, rng)
        do_eg = step % 3 == 0
        masks = [draw_masks(D, B, rng) for _ in range(4)]
        z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (B, 1, 1, 32)))
        queue.masks = [m for fwd in (masks if do_eg else masks[2:]) for m in fwd]
        with jax.disable_jit():
            st, ref = jtr.train_step(st, jax.tree_util.tree_map(jnp.asarray, batch))
        got = tr.train_step(to_torch(batch), z=torch.from_numpy(z),
                            masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
        for k in ref:
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} at step {step}")
    want, have = gan_state_from_jax(as_tree(st)), tr.state_dict()
    assert have["step"] == want["step"] == GAN_STEPS
    assert have["opt_eg"]["count"] == GAN_STEPS // 3 and have["opt_d"]["count"] == 2 * GAN_STEPS
    for part in ("E", "G", "D"):
        for name, w in want[part].items():
            got = have[part][name].detach().numpy()
            if name.endswith((".mean", ".var")):
                np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{part}.{name}")
            else:
                updates = 2 * GAN_STEPS if part == "D" else GAN_STEPS // 3
                assert_follows(got, w.numpy(), updates, f"{part}.{name} after {GAN_STEPS} steps")


def test_vae_trainer_follows_jax_for_64_steps():
    b, s = 8, 4
    tcfg = dict(batch_size=b, num_samples_per_step=s, kl_weight=10.0, learning_rate=LR)
    jtr = jvt.VAETrainer(jvae.ConditionalVAE(tiny_vae_config(jvae)), jvt.VAETrainConfig(**tcfg))
    st = jtr.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = redraw(st.params, rng)
    st = st.replace(params=params, opt=jtr.tx.init(params))
    tmodel = vae_params_from_jax(jax.device_get(st.params), tiny_vae_config(tvae), "cpu")
    ttr = VAETrainer(tmodel, VAETrainConfig(**tcfg), "cpu")
    step = jax.jit(jtr.train_step)
    for i in range(VAE_STEPS):
        x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
        a = attrs_np(b, rng)
        # the noise JAX's step draws: split(state.rng)[1] -> normal (B, S, 1, 1, latent)
        eps = np.array(jax.random.normal(jax.random.split(st.rng)[1], (b, s, 1, 1, 16), jnp.float32))
        st, ref = step(st, {"image": jnp.asarray(x), "attrs": {k: jnp.asarray(v) for k, v in a.items()}})
        got = ttr.train_step({"image": torch.from_numpy(x), "attrs": {k: torch.from_numpy(v) for k, v in a.items()}},
                             eps=torch.from_numpy(eps))
        np.testing.assert_allclose(got["neg_elbo"].item(), float(ref["neg_elbo"]), rtol=1e-5,
                                   err_msg=f"-elbo at step {i}")
    assert ttr.step == VAE_STEPS and ttr.opt.count == VAE_STEPS
    named = dict(tmodel.named_parameters())
    for name, w in vae_state_dict_from_jax(jax.device_get(st.params)).items():
        assert_follows(named[name].detach().numpy(), w.numpy(), VAE_STEPS, f"{name} after {VAE_STEPS} steps")
