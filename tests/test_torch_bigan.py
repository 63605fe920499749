"""The port's BiGAN encoder and generator against the JAX modules, with the
JAX params carried across by ``bigan_params_from_jax``.

Weights are redrawn with numpy at N(0, 1/sqrt(fan_in)) so activations stay
O(1) through the stacks. Tolerance 2e-4 absolute and 1e-4 relative: a
five-conv stack summed in f32 in another order, as in
``tests/test_pallas_ops.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models.bigan import BiGAN as JBiGAN
from imagecfgen_tpu.models.bigan import audio_mnist_bigan_config as j_audio_cfg
from imagecfgen_tpu.models.bigan import mnist_bigan_config as j_cfg
from imagecfgen_torch.core.convert import bigan_params_from_jax
from imagecfgen_torch.models.bigan import (
    AUDIO_MNIST_SPEC,
    Encoder,
    Generator,
    audio_mnist_bigan_config,
    mnist_bigan_config,
)
from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward


def _attrs(b, rng):
    a = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]}
    for k in ("intensity", "slant", "thickness"):
        a[k] = rng.uniform(-1, 1, b).astype(np.float32)
    return a


def _redraw(params, rng):
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


def _pair(latent, seed=0, b=4):
    rng = np.random.default_rng(seed)
    jm = JBiGAN(j_cfg(latent_dim=latent))
    a = _attrs(b, rng)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    z = rng.normal(0, 1, (b, 1, 1, latent)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.asarray(z), a)["params"], rng)
    tm = bigan_params_from_jax(pE, pG, mnist_bigan_config(latent), device="cpu")
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    return jm, pE, pG, tm, x, z, a, ta


@pytest.mark.parametrize("latent", [64, 512])
def test_encoder_matches_jax(latent):
    jm, pE, _, tm, x, _, a, ta = _pair(latent)
    ref = jm.encoder.apply({"params": pE}, jnp.asarray(x), a)
    before = fused_encoder_forward.launches
    with torch.no_grad():
        out = tm.encoder(torch.from_numpy(x), ta)
    assert fused_encoder_forward.launches == before  # CPU: the plain version
    assert tuple(out.shape) == ref.shape == (4, 1, 1, latent)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("latent", [64, 512])
def test_generator_matches_jax(latent):
    jm, _, pG, tm, _, z, a, ta = _pair(latent, seed=1)
    ref = jm.generator.apply({"params": pG}, jnp.asarray(z), a)
    with torch.no_grad():
        out = tm.generator(torch.from_numpy(z), ta)
    assert tuple(out.shape) == ref.shape == (4, 28, 28, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_encoder_trunk_equals_plan_sequential():
    """The fused route and the plan interpreter compute the same trunk."""
    _, _, _, tm, x, _, _, ta = _pair(64, seed=2)
    enc = tm.encoder
    with torch.no_grad():
        feats = enc.attr_channels(torch.from_numpy(x), ta)
        np.testing.assert_allclose(enc(torch.from_numpy(x), ta).numpy(), enc.trunk(feats).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_builders_carry_config_shapes():
    cfg = mnist_bigan_config()
    enc = Encoder(cfg, device="cpu", rng=torch.Generator().manual_seed(0))
    assert enc.trunk.out_shape == (1, 1, 512)
    assert tuple(enc.trunk.conv_0_kernel.shape) == (64, 5, 3, 3)
    std = enc.trunk.conv_1_kernel.detach().std().item()
    assert abs(std - cfg.init_std) < 0.1 * cfg.init_std
    assert float(enc.trunk.conv_1_bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("latent", [64, 512])
def test_mnist_config_matches_jax(latent):
    t, j = mnist_bigan_config(latent), j_cfg(latent_dim=latent)
    assert (t.enc_plan, t.gen_plan) == (j.enc_plan, j.gen_plan)
    assert (t.image_size, t.image_channels, t.latent_dim, t.embed_dim, t.embed_hw, t.init_std) == (
        j.image_size, j.image_channels, j.latent_dim, j.embed_dim, j.embed_hw, j.init_std)
    assert t.attr_spec.names == j.attr_spec.names


# ------------------------------------------------------------ AudioMNIST

AUDIO_D, AUDIO_LATENT = 8, 64


def _audio_attrs(b, rng):
    return {a.name: np.eye(a.n_categories, dtype=np.float32)[rng.integers(0, a.n_categories, b)]
            for a in AUDIO_MNIST_SPEC}


@pytest.fixture(scope="module")
def audio_pair():
    rng = np.random.default_rng(3)
    b = 2
    jm = JBiGAN(j_audio_cfg(d=AUDIO_D, latent_dim=AUDIO_LATENT))
    a = _audio_attrs(b, rng)
    x = rng.uniform(-1, 1, (b, 128, 128, 1)).astype(np.float32)
    z = rng.normal(0, 1, (b, 1, 1, AUDIO_LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    pE = _redraw(jm.encoder.init({"params": key}, jnp.asarray(x), a)["params"], rng)
    pG = _redraw(jm.generator.init({"params": key}, jnp.asarray(z), a)["params"], rng)
    tm = bigan_params_from_jax(pE, pG, audio_mnist_bigan_config(AUDIO_D, AUDIO_LATENT), device="cpu")
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    return jm, pE, pG, tm, x, z, a, ta


def test_audio_encoder_matches_jax(audio_pair):
    """Six k5/s2/p1 convs over the image and six categorical channels."""
    jm, pE, _, tm, x, _, a, ta = audio_pair
    ref = jm.encoder.apply({"params": pE}, jnp.asarray(x), a)
    with torch.no_grad():
        out = tm.encoder(torch.from_numpy(x), ta)
    assert tuple(out.shape) == ref.shape == (2, 1, 1, AUDIO_LATENT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_audio_generator_matches_jax(audio_pair):
    """The dense stem, then k5/s2/p2/op1 transposed convs 4 -> 128."""
    jm, _, pG, tm, _, z, a, ta = audio_pair
    ref = jm.generator.apply({"params": pG}, jnp.asarray(z), a)
    with torch.no_grad():
        out = tm.generator(torch.from_numpy(z), ta)
    assert tuple(out.shape) == ref.shape == (2, 128, 128, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_audio_dense_stem_is_carried_transposed(audio_pair):
    _, _, pG, tm, _, _, _, _ = audio_pair
    jk = pG["trunk"]["dense_0_kernel"]
    tk = tm.generator.trunk.dense_0_kernel.detach().numpy()
    assert jk.shape == (AUDIO_LATENT + 6 * 256, 256 * AUDIO_D)
    np.testing.assert_array_equal(tk, jk.T)
    np.testing.assert_array_equal(tm.generator.trunk.dense_0_bias.detach().numpy(),
                                  pG["trunk"]["dense_0_bias"])


@pytest.mark.parametrize("d,latent", [(64, 512), (8, 64)])
def test_audio_config_matches_jax(d, latent):
    t, j = audio_mnist_bigan_config(d, latent), j_audio_cfg(d=d, latent_dim=latent)
    assert (t.enc_plan, t.gen_plan, t.gen_input) == (j.enc_plan, j.gen_plan, j.gen_input)
    assert (t.image_size, t.image_channels, t.latent_dim, t.embed_dim, t.embed_hw, t.init_std) == (
        j.image_size, j.image_channels, j.latent_dim, j.embed_dim, j.embed_hw, j.init_std)
    assert t.attr_spec == AUDIO_MNIST_SPEC
    assert [(x.name, x.n_categories) for x in t.attr_spec] == [
        (x.name, x.n_categories) for x in j.attr_spec]


def test_generator_input_modes():
    cfg = audio_mnist_bigan_config(AUDIO_D, AUDIO_LATENT)
    g = Generator(cfg, device="cpu")
    assert g.trunk.dense_0_kernel.shape[1] == AUDIO_LATENT + 6 * 256
    assert g.trunk.out_shape == (128, 128, 1)
    with pytest.raises(ValueError, match="gen_input"):
        Generator(dataclasses.replace(cfg, gen_input="other"), device="cpu")
