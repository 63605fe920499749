"""The port's fused-encoder module against the JAX package's.

Same inputs (numpy, from a seed) go through ``imagecfgen_tpu`` and
``imagecfgen_torch``. Tolerance for the conv stack: 2e-4 absolute, as in
``tests/test_pallas_ops.py`` — both sides sum f32 products of a five-layer
stack in different orders.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.ops.pallas import fused_encoder as jfe
from imagecfgen_torch.core.convert import plan_state_dict_from_jax
from imagecfgen_torch.ops import fused_encoder as tfe

ATOL = 2e-4


def _trunk(seed=0, latent=512):
    """Full-width MNIST encoder trunk, weights N(0, 0.05) as in
    ``tests/test_pallas_ops.py``: JAX (HWIO) and port (PyTorch layout)."""
    plan = jbigan.mnist_bigan_config(latent_dim=latent).enc_plan
    rng = np.random.default_rng(seed)
    c_in, params, i = 5, {}, 0
    for op in plan:
        if op[0] != "conv":
            continue
        ch, k = op[1], op[2]
        params[f"conv_{i}_kernel"] = rng.normal(0, 0.05, (k, k, c_in, ch)).astype(np.float32)
        params[f"conv_{i}_bias"] = rng.normal(0, 0.05, ch).astype(np.float32)
        c_in, i = ch, i + 1
    return plan, params, plan_state_dict_from_jax(params)


def _feats(b, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (b, 28, 28, 5)).astype(np.float32)


def _jax_pairs(params, n):
    return [(jnp.asarray(params[f"conv_{j}_kernel"]), jnp.asarray(params[f"conv_{j}_bias"]))
            for j in range(n)]


def _torch_pairs(tparams, n):
    return [(tparams[f"conv_{j}_kernel"], tparams[f"conv_{j}_bias"]) for j in range(n)]


@pytest.mark.parametrize("config", ["mnist", "mnist64", "audio", "whale", "esrf"])
def test_plan_conv_ops_matches_jax(config):
    cfg = {
        "mnist": jbigan.mnist_bigan_config,
        "mnist64": lambda: jbigan.mnist_bigan_config(latent_dim=64),
        "audio": jbigan.audio_mnist_bigan_config,
        "whale": jbigan.whale_bigan_config,
        "esrf": jbigan.esrf_bigan_config,
    }[config]()
    assert tfe.plan_conv_ops(cfg.enc_plan) == jfe.plan_conv_ops(cfg.enc_plan)


@pytest.mark.parametrize("plan", [
    (("bn",),),
    (("lrelu", 0.2), ("conv", 8, 3, 1, 0)),
    (("conv", 8, 3, 1, 0), ("tanh",)),
])
def test_plan_conv_ops_rejects_like_jax(plan):
    with pytest.raises(ValueError):
        jfe.plan_conv_ops(plan)
    with pytest.raises(ValueError):
        tfe.plan_conv_ops(plan)


def test_trunk_weights_matches_jax():
    _, params, tparams = _trunk()
    j = jfe.trunk_weights(params)
    t = tfe.trunk_weights(tparams)
    assert len(t) == len(j) == 10
    for jw, tw in zip(j, t):
        assert tuple(tw.shape) == (jw.shape if jw.ndim == 1 else
                                   (jw.shape[3], jw.shape[2], jw.shape[0], jw.shape[1]))


@pytest.mark.parametrize("b", [32, 5])
def test_reference_matches_xla(b):
    """The plain version equals the JAX package's XLA trunk, also for a
    batch that no tile divides."""
    plan, params, tparams = _trunk()
    ops = tfe.plan_conv_ops(plan)
    feats = _feats(b)
    ref = jfe._xla_reference(jnp.asarray(feats), _jax_pairs(params, len(ops)), ops)
    out = tfe.fused_encoder_reference(torch.from_numpy(feats), _torch_pairs(tparams, len(ops)), ops)
    assert out.shape == ref.shape == (b, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [0, 2])
def test_reference_matches_pallas_interpret(split):
    """The plain version equals the Pallas kernel run in interpret mode,
    fully fused and with the first convs split off."""
    plan, params, tparams = _trunk(latent=64)
    ops = tfe.plan_conv_ops(plan)
    feats = _feats(8, seed=3)
    pallas = jfe.fused_encoder_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats), plan,
        batch_tile=4, split=split, interpret=True,
    )
    out = tfe.fused_encoder_reference(torch.from_numpy(feats), _torch_pairs(tparams, len(ops)), ops)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [0, 2])
def test_wrapper_takes_plain_version_on_cpu(split):
    plan, params, tparams = _trunk(latent=64)
    ops = tfe.plan_conv_ops(plan)
    feats = torch.from_numpy(_feats(3, seed=4))
    before = tfe.fused_encoder_forward.launches
    out = tfe.fused_encoder_forward(tparams, feats, plan, split=split)
    assert tfe.fused_encoder_forward.launches == before
    ref = tfe.fused_encoder_reference(feats, _torch_pairs(tparams, len(ops)), ops)
    assert torch.equal(out, ref)


def test_wrapper_checks_its_inputs():
    plan, _, tparams = _trunk(latent=64)
    with pytest.raises(ValueError):
        tfe.fused_encoder_forward(tparams, torch.zeros(28, 28, 5), plan)
    del tparams["conv_4_kernel"], tparams["conv_4_bias"]
    with pytest.raises(ValueError):
        tfe.fused_encoder_forward(tparams, torch.zeros(1, 28, 28, 5), plan)


def test_cuda_source_names_the_kernel_it_replaces():
    src = Path(tfe.__file__).resolve().parents[1] / "csrc" / "fused_encoder.cu"
    text = src.read_text()
    assert "imagecfgen_tpu/ops/pallas/fused_encoder.py" in text
    assert "_pallas_encoder" in text
    assert 'extern "C" int fused_encoder_run' in text
    for banned in ("cudnn", "cublas", "torch/extension.h"):
        assert banned not in text.lower()
