"""The port's marine models against the JAX package's, on the CPU: the 256^2
whale-call and 512^2 ESRF BiGANs (encoder, generator, discriminator) and
the whale VAE (encoder, decoder, ELBO), at d = 2 and latent 32, batch 2,
at the real image sizes, with the JAX parameters carried across by
``core.convert`` and redrawn with numpy at N(0, 1/sqrt(fan_in)) so the
activations stay O(1).

Tolerance 2e-4 absolute and 1e-4 relative (``tests/test_torch_bigan.py``:
a conv stack summed in float32 in another order); the ELBO, a sum over
65,536 pixels, to 1e-4 relative. The configs at full width (d = 64,
latent 512) are the JAX package's plan for plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layers import attrs_for, redraw

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.models.layers import PlanSequential as JPlan
from imagecfgen_torch.core.convert import (
    bigan_params_from_jax,
    discriminator_from_jax,
    plan_state_dict_from_jax,
    vae_params_from_jax,
    vae_state_dict_from_jax,
)
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import vae as tvae
from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

TOL = dict(rtol=1e-4, atol=2e-4)
D, LATENT, B = 2, 32, 2
DOMAINS = ("whale", "esrf")


def configs(mod, domain, **kw):
    return getattr(mod, f"{domain}_bigan_config")(d=D, latent_dim=LATENT, **kw)


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("d,latent", [(64, 512), (D, LATENT)])
def test_configs_are_the_jax_packages(domain, d, latent):
    t = getattr(tbigan, f"{domain}_bigan_config")(d=d, latent_dim=latent)
    j = getattr(jbigan, f"{domain}_bigan_config")(d=d, latent_dim=latent)
    for field in ("enc_plan", "gen_plan", "dx_plan", "dz_plan", "dxz_plan", "image_size", "image_channels",
                  "latent_dim", "embed_dim", "embed_hw", "init_std", "gen_input", "vae_trunk_tail"):
        assert getattr(t, field) == getattr(j, field), field
    assert [(a.name, a.n_categories) for a in t.attr_spec] == [(a.name, a.n_categories) for a in j.attr_spec]
    if domain == "whale":  # D's x tower differs from E's in its third layer
        assert t.dx_plan != t.enc_plan and t.dx_plan[4] == ("conv", 2 * d, 5, 2, 1)
    for name in ("whale_vae_config",):
        tv, jv = getattr(tvae, name)(d=d, latent_dim=latent), getattr(jvae, name)(d=d, latent_dim=latent)
        for field in ("enc_plan", "gen_plan", "vae_trunk_tail", "init_std", "latent_dim"):
            assert getattr(tv, field) == getattr(jv, field), field
        assert tv.vae_trunk_tail == ()


def test_input_channels_and_dense_stems():
    whale, esrf = tbigan.whale_bigan_config(), tbigan.esrf_bigan_config()
    assert tbigan.Encoder(configs(tbigan, "whale"), "cpu").trunk.conv_0_kernel.shape[1] == 2
    assert tbigan.Encoder(configs(tbigan, "esrf"), "cpu").trunk.conv_0_kernel.shape[1] == 3
    g = tbigan.Generator(configs(tbigan, "esrf"), "cpu")
    assert g.trunk.dense_0_kernel.shape == (256 * D, LATENT + 256 + 1)
    assert (whale.image_size, esrf.image_size) == ((256, 256), (512, 512))
    # both generators start dense -> reshape -> lrelu: no dense -> lrelu to fuse
    for cfg in (whale, esrf):
        assert cfg.gen_plan[0][0] == "dense" and cfg.gen_plan[1][0] == "reshape"


@pytest.fixture(scope="module", params=DOMAINS)
def pair(request):
    domain = request.param
    rng = np.random.default_rng({"whale": 10, "esrf": 11}[domain])
    jm = jbigan.BiGAN(configs(jbigan, domain))
    cfg = configs(tbigan, domain)
    h, w = cfg.image_size
    x = rng.uniform(-1, 1, (B, h, w, 1)).astype(np.float32)
    z = rng.normal(0, 1, (B, 1, 1, LATENT)).astype(np.float32)
    a = attrs_for(cfg.attr_spec, B, rng)
    key = jax.random.PRNGKey(3)
    pE = redraw(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"], rng)
    pG = redraw(jm.generator.init({"params": key}, jnp.asarray(z), a)["params"], rng)
    vD = jm.discriminator.init({"params": key}, jnp.asarray(x), jnp.asarray(z), a)
    pD = redraw(vD["params"], rng)
    tm = bigan_params_from_jax(pE, pG, cfg, device="cpu")
    tD = discriminator_from_jax({"params": pD}, cfg, "cpu").eval()
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    return domain, jm, (pE, pG, pD), tm, tD, x, z, a, ta


def test_encoder_matches_jax(pair):
    domain, jm, (pE, _, _), tm, _, x, _, a, ta = pair
    want = jm.encoder.apply({"params": pE}, jnp.asarray(x), a)
    before = fused_encoder_forward.launches
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(x), ta)
    assert fused_encoder_forward.launches == before  # on the CPU: the plain version
    assert tuple(got.shape) == want.shape == (B, 1, 1, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_encoder_forward_on_the_trunk_matches_jax_plan_sequential(pair):
    """``fused_encoder_forward`` on the whole trunk (seven layers at 256^2,
    eight at 512^2) against the JAX package's ``PlanSequential`` of the same
    plan, on the same N(0, 1) features."""
    domain, _, (pE, _, _), tm, _, x, _, _, _ = pair
    cfg = tm.cfg
    c_in = tm.encoder.trunk.conv_0_kernel.shape[1]
    feats = np.random.default_rng(5).normal(0, 1, (B, *cfg.image_size, c_in)).astype(np.float32)
    want = JPlan(cfg.enc_plan, cfg.init_std).apply({"params": pE["trunk"]}, jnp.asarray(feats))
    got = fused_encoder_forward(plan_state_dict_from_jax(pE["trunk"]), torch.from_numpy(feats), cfg.enc_plan)
    assert tuple(got.shape) == (B, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, -1), **TOL)


def test_generator_matches_jax(pair):
    domain, jm, (_, pG, _), tm, _, _, z, a, ta = pair
    want = jm.generator.apply({"params": pG}, jnp.asarray(z), a)
    with torch.no_grad():
        got = tm.generator(torch.from_numpy(z), ta)
    assert tuple(got.shape) == want.shape == (B, *tm.cfg.image_size, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_discriminator_matches_jax(pair):
    domain, jm, (_, _, pD), _, tD, x, z, a, ta = pair
    want = jm.discriminator.apply({"params": pD}, jnp.asarray(x), jnp.asarray(z), a)
    with torch.no_grad():
        got = tD(torch.from_numpy(x), torch.from_numpy(z), ta)
    assert tuple(got.shape) == want.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ the whale VAE


@pytest.fixture(scope="module")
def vae_pair():
    rng = np.random.default_rng(12)
    jm = jvae.ConditionalVAE(jvae.whale_vae_config(d=D, latent_dim=LATENT))
    x = rng.uniform(-1, 1, (B, 256, 256, 1)).astype(np.float32)
    a = attrs_for(jbigan.WHALE_SPEC, B, rng)
    key = jax.random.PRNGKey(0)
    zeros = jnp.zeros((B, 1, 1, LATENT))
    params = redraw({"encoder": jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"],
                     "decoder": jm.decoder.init({"params": key}, zeros, a)["params"]}, rng)
    tm = vae_params_from_jax(params, tvae.whale_vae_config(d=D, latent_dim=LATENT), "cpu").eval()
    return jm, params, tm, x, a, {k: torch.from_numpy(v) for k, v in a.items()}


def test_vae_converter_covers_every_parameter(vae_pair):
    _, params, tm, *_ = vae_pair
    sd = vae_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())


def test_vae_encoder_and_decoder_match_jax(vae_pair, monkeypatch):
    """No LeakyReLU after the whale trunk: the served route (the whole
    trunk through ``fused_encoder_forward``, nothing after it) and the
    differentiable route give the JAX encoder's mean and log-variance."""
    jm, params, tm, x, a, ta = vae_pair
    want_mean, want_lv = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x), a)
    calls = []
    real = tvae.fused_encoder_forward
    monkeypatch.setattr(tvae, "fused_encoder_forward", lambda *args, **kw: calls.append(1) or real(*args, **kw))
    with torch.no_grad():
        mean, log_var = tm.encoder(torch.from_numpy(x), ta)
        served = tm.encoder.features(torch.from_numpy(x), ta)
    assert len(calls) == 2
    trained = tm.encoder.features(torch.from_numpy(x), ta)
    assert len(calls) == 2 and trained.requires_grad
    np.testing.assert_allclose(served.numpy(), trained.detach().numpy(), **TOL)
    assert (served.numpy() < -0.05).any()  # no LeakyReLU: negatives pass at full size
    assert tuple(mean.shape) == want_mean.shape == (B, 1, 1, LATENT)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(log_var.numpy(), np.asarray(want_lv), **TOL)
    z = np.random.default_rng(6).normal(0, 1, (B, 1, 1, LATENT)).astype(np.float32)
    want = jm.decoder.apply({"params": params["decoder"]}, jnp.asarray(z), a)
    with torch.no_grad():
        got = tm.decoder(torch.from_numpy(z), ta)
    assert tuple(got.shape) == want.shape == (B, 256, 256, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vae_elbo_with_jax_noise_matches_jax(vae_pair):
    jm, params, tm, x, a, ta = vae_pair
    key = jax.random.PRNGKey(9)
    for s, kl in ((2, 1.0), (3, 10.0)):
        eps = np.array(jax.random.normal(key, (B, s, 1, 1, LATENT), jnp.float32))
        want = float(jm.elbo(params, key, jnp.asarray(x), a, num_samples=s, kl_weight=kl))
        with torch.no_grad():
            got = float(tm.elbo(torch.from_numpy(x), ta, num_samples=s, kl_weight=kl, eps=torch.from_numpy(eps)))
        assert np.isfinite(want)
        np.testing.assert_allclose(got, want, rtol=1e-4)
