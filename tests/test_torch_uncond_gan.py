"""The port's unconditional GAN / WGAN-GP (``models/gan.py``,
``train/uncond_gan_trainer.py``) against the JAX package's on the CPU, at
d = 2 (128x128 spectrograms, latent 100), on the same numpy-drawn O(1)
weights carried across by ``core.convert.uncond_gan_state_from_jax``.

- G and D forward: 1e-5 relative plus 1e-5 of the output's largest value;
- ``gradient_penalty`` and ``wgan_disc_loss`` with the JAX package's
  interpolation weights, and their gradients with respect to D's
  parameters (a gradient of a gradient): 1e-5 relative, gradients to 1e-4
  relative plus 1e-5 of each tensor's largest entry;
- the trainer: four steps in each loss mode, with and without the
  discriminator's decoupled weight decay, ``d_updates_per_g_update = 2`` (G
  updated on even steps only), ``z``, ``z'`` and the penalty's weights drawn
  under the keys the JAX step derives (``split(state.rng, 4)``) and injected.
  Losses to 1e-5 relative; parameters as in ``test_torch_gan_trainer.py``
  (Adam's first updates are ``lr * g / |g|``: 1e-5 relative plus ``0.02 lr``
  per step, one element in a thousand allowed up to ``2 lr`` per step);
  moments 1e-4 relative plus 2e-5 of the tensor's largest entry;
- neither network meets the ``fused_dense`` peephole, so the penalty's
  double backward never reaches ``FusedDenseLReLU``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layers import redraw

from imagecfgen_tpu.models import gan as jgan
from imagecfgen_tpu.train import uncond_gan_trainer as jug
from imagecfgen_torch.core.convert import uncond_gan_state_from_jax
from imagecfgen_torch.models import gan as tgan
from imagecfgen_torch.models import layers as tlayers
from imagecfgen_torch.train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer

D, B, LR = 2, 4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: this file's 128x128 convs beside the suite's
    other workers would oversubscribe the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_tree(st):
    """A JAX ``UncondGANState`` as the numpy tree its checkpoint holds."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def adam(opt):
        return [dict(count=np.asarray(opt[0].count), mu=to_np(opt[0].mu), nu=to_np(opt[0].nu)),
                *({} for _ in opt[1:])]

    return {"params_G": to_np(st.params_G), "params_D": to_np(st.params_D), "step": np.asarray(st.step),
            "opt_g": adam(st.opt_g), "opt_d": adam(st.opt_d)}


def jax_state(seed, **tcfg):
    """A JAX trainer and a state with redrawn O(1) parameters (the config's
    1e-3 init leaves every activation near zero)."""
    rng = np.random.default_rng(seed)
    jtr = jug.UncondGANTrainer(jgan.UncondGANConfig(d=D), jug.UncondGANTrainConfig(batch_size=B, **tcfg))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    pG, pD = redraw(st.params_G, rng), redraw(st.params_D, rng)
    st = st.replace(params_G=pG, params_D=pD, opt_g=jtr.tx_g.init(pG), opt_d=jtr.tx_d.init(pD))
    return jtr, st, rng


def port_trainer(st, **tcfg):
    tr = UncondGANTrainer(tgan.UncondGANConfig(d=D), UncondGANTrainConfig(batch_size=B, **tcfg), "cpu")
    tr.load_state_dict(uncond_gan_state_from_jax(as_tree(st)))
    return tr


def images(rng, n=B):
    return rng.uniform(-1, 1, (n, 128, 128, 1)).astype(np.float32)


def close(got, want, rtol=1e-5, top=1e-5, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol, atol=top * float(np.abs(want).max()), err_msg=msg)


def test_generator_and_discriminator_forward():
    jtr, st, rng = jax_state(0)
    tr = port_trainer(st)
    z, x = rng.normal(0, 1, (B, 100)).astype(np.float32), images(rng)
    want_g = np.asarray(jtr.G.apply({"params": st.params_G}, jnp.asarray(z)))
    want_d = np.asarray(jtr.D.apply({"params": st.params_D}, jnp.asarray(x)))
    with torch.no_grad():
        got_g = tr.G(torch.from_numpy(z)).numpy()
        got_d = tr.D(torch.from_numpy(x)).numpy()
    assert got_g.shape == (B, 128, 128, 1) and got_d.shape == (B, 1)
    close(got_g, want_g, msg="G")
    close(got_d, want_d, msg="D")


def test_neither_network_meets_the_fused_dense_peephole(monkeypatch):
    """The penalty differentiates D's input gradient again; ``FusedDenseLReLU``'s
    backward cannot be, so neither plan may have a dense -> lrelu pair."""
    cfg = tgan.UncondGANConfig(d=D)
    for plan in (cfg.gen_plan, cfg.disc_plan):
        assert not any(a[0] == "dense" and b[0] == "lrelu" for a, b in zip(plan, plan[1:])), plan

    def refuse(*args, **kw):
        raise AssertionError("the fused_dense peephole fired")

    monkeypatch.setattr(tlayers, "fused_dense_lrelu", refuse)
    tr = UncondGANTrainer(cfg, UncondGANTrainConfig(batch_size=B, loss_mode="wgan"), "cpu")
    rng = np.random.default_rng(1)
    m = tr.train_step({"image": torch.from_numpy(images(rng))})
    assert all(torch.isfinite(v) for v in m.values())


@pytest.mark.parametrize("what", ["gradient_penalty", "wgan_disc_loss"])
def test_penalty_and_wgan_loss_with_their_gradients(what):
    jtr, st, rng = jax_state(2)
    tr = port_trainer(st)
    real, fake = images(rng), images(rng)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.uniform(key, (B, 1, 1, 1)))

    def d_apply(p, img):
        return jtr.D.apply({"params": p}, img, train=True)

    def jloss(p):
        if what == "gradient_penalty":
            return jgan.gradient_penalty(d_apply, p, jnp.asarray(real), jnp.asarray(fake), key)
        return jgan.wgan_disc_loss(d_apply, p, jnp.asarray(real), jnp.asarray(fake), key, 10.0)

    want, jgrads = jax.value_and_grad(jloss)(st.params_D)
    fn = getattr(tgan, what)
    got = fn(lambda img: tr.D(img, train=True), torch.from_numpy(real), torch.from_numpy(fake),
             torch.from_numpy(eps))
    params = dict(tr.D.named_parameters())
    # the penalty alone does not reach D's last bias: JAX's gradient is 0 there
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in
             zip(params.items(), torch.autograd.grad(got, list(params.values()), allow_unused=True))}
    close(got.item(), float(want), msg=what)
    want_grads = uncond_gan_state_from_jax({**as_tree(st), "params_D": jax.device_get(jgrads)})["D"]
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        close(g.numpy(), want_grads[name].numpy(), rtol=1e-4, msg=f"d {what} / d {name}")


def assert_state_close(tr, st, steps):
    ref, got = uncond_gan_state_from_jax(as_tree(st)), tr.state_dict()
    assert got["step"] == ref["step"] == steps
    for part in ("G", "D"):
        assert set(got[part]) == set(ref[part])
        for name, want in ref[part].items():
            have, want = got[part][name].numpy(), want.numpy()
            err = np.abs(have - want)
            tight = err <= 0.02 * LR * steps + 1e-5 * steps * np.abs(want)
            assert tight.mean() >= 0.999, f"{part}.{name} after {steps} steps: {(~tight).sum()} elements off"
            assert err.max() <= 2 * LR * steps, f"{part}.{name} after {steps} steps: off by {err.max()}"
    for opt in ("opt_g", "opt_d"):
        assert got[opt]["count"] == ref[opt]["count"]
        for moment in ("mu", "nu"):
            for name, want in ref[opt][moment].items():
                np.testing.assert_allclose(got[opt][moment][name].numpy(), want.numpy(), rtol=1e-4,
                                           atol=2e-5 * float(want.abs().max()), err_msg=f"{opt}.{moment}.{name}")


@pytest.mark.parametrize("mode,decay", [("gan", 0.0), ("gan", 0.1), ("wgan", 0.0), ("wgan", 0.1)])
def test_four_steps_follow_jax(mode, decay):
    kw = dict(loss_mode=mode, d_updates_per_g_update=2, discriminator_weight_decay=decay)
    jtr, st, rng = jax_state(3, **kw)
    tr = port_trainer(st, **kw)
    assert tr.opt_d.weight_decay == decay
    step = jax.jit(jtr.train_step)
    for i in range(4):
        x = images(rng)
        _, kz1, kz2, kgp = jax.random.split(st.rng, 4)
        z_g, z_d = (np.asarray(jax.random.normal(k, (B, 100))) for k in (kz1, kz2))
        eps = np.asarray(jax.random.uniform(kgp, (B, 1, 1, 1)))
        g_before = [p.detach().clone() for p in tr.params_g]
        st, ref = step(st, {"image": jnp.asarray(x)})
        got = tr.train_step({"image": torch.from_numpy(x)}, torch.from_numpy(z_g), torch.from_numpy(z_d),
                            torch.from_numpy(eps))
        for k in ("loss_G", "loss_D"):
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=f"{k}, step {i}")
        moved = any(not torch.equal(p, q) for p, q in zip(tr.params_g, g_before))
        assert moved == (i % 2 == 0) == (got["loss_G"].item() != 0.0), f"G at step {i}"
        if i == 0:
            assert_state_close(tr, st, 1)
    assert_state_close(tr, st, 4)
    assert tr.opt_g.count == 2 and tr.opt_d.count == 4


def test_state_dict_round_trip_continues_bit_for_bit():
    cfg, tcfg = tgan.UncondGANConfig(d=D), UncondGANTrainConfig(batch_size=B, loss_mode="wgan")
    a = UncondGANTrainer(cfg, tcfg, "cpu", seed=4)
    rng = np.random.default_rng(4)
    data = a.upload_dataset(images(rng, 3 * B))
    a.fit_epoch(data)
    b = UncondGANTrainer(cfg, tcfg, "cpu", seed=9)
    b.load_state_dict(a.state_dict())
    ma, mb = a.fit_epoch(data), b.fit_epoch(data)
    assert ma == mb
    for (n, p), q in zip(a.G.state_dict().items(), b.G.state_dict().values()):
        assert torch.equal(p, q), n
    for (n, p), q in zip(a.D.state_dict().items(), b.D.state_dict().values()):
        assert torch.equal(p, q), n


def test_unknown_loss_mode_raises():
    with pytest.raises(ValueError, match="loss_mode"):
        UncondGANTrainer(tgan.UncondGANConfig(d=D), UncondGANTrainConfig(loss_mode="hinge"), "cpu")


@pytest.mark.parametrize("decay", [0.1, 1e-4])
def test_adam_with_weight_decay_is_optax_adamw(decay):
    """``train/optim.py::Adam(weight_decay=...)`` against ``optax.adamw`` with
    the discriminator's settings: three parameters of different shapes in one
    flat optimiser, five steps; parameters and moments to float32 rounding."""
    import optax

    shapes = [(3, 4), (7,), (2, 2, 3)]
    rng = np.random.default_rng(0)
    w0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(5)]
    tx = optax.adamw(LR, b1=0.5, b2=0.9, weight_decay=decay)
    w = [jnp.asarray(v) for v in w0]
    opt = tx.init(w)
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in w0]
    from imagecfgen_torch.train.optim import Adam

    topt = Adam(ps, LR, (0.5, 0.9), weight_decay=decay)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(v) for v in g], opt, w)
        w = optax.apply_updates(w, upd)
        for p, v in zip(ps, g):
            p.grad = torch.from_numpy(v.copy())
        topt.step()
    mu, nu = topt.moments()
    for i, p in enumerate(ps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w[i]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(mu[i].numpy(), np.asarray(opt[0].mu[i]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(nu[i].numpy(), np.asarray(opt[0].nu[i]), rtol=1e-6, atol=1e-12)
    # the decay moved the parameters beyond Adam's own step
    plain = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in w0]
    popt = Adam(plain, LR, (0.5, 0.9))
    for g in grads:
        for p, v in zip(plain, g):
            p.grad = torch.from_numpy(v.copy())
        popt.step()
    assert not all(torch.equal(a, b) for a, b in zip(ps, plain))
