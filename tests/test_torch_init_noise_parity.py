"""The MNIST BiGAN's initial parameters and one training step's noise, at the
battery's full width on the CPU: the port against the JAX package in
distribution (the two packages' random streams differ, so no draw is equal).

- Every tensor of E, G and D has the JAX tensor's name and shape after the
  converter's layout (``core/convert.py``).
- Each kernel of at least 1,000 elements has the JAX kernel's standard
  deviation within 5 %, or within four standard errors of the ratio of two
  sample deviations of ``n`` normal draws (``sqrt(1/n)``) where that is
  wider: at ``n`` = 1,024 (G's last transposed conv) sampling alone moves the
  ratio by 3 % a standard error.
- Biases and batch-norm shifts are zero, batch-norm scales one, running
  statistics zero and one; each embedding table's deviation is within 5 % of
  1 (``N(0, 1)``, as flax's ``Embed`` draws it).
- One port training step with the battery's flags (batch 64,
  ``d_updates_per_g_update=3``; its first, which updates E and G; the
  phases' arithmetic stubbed, as a full-width step takes about 10 s on the
  CPU) draws once, hands its phases what it drew, and draws ``z`` of shape
  (64, 1, 1, 512) with
  mean within 0.02 of 0 and deviation within 2 % of 1, and one set of D
  dropout masks for each dropout key the JAX step hands to D
  (``imagecfgen_tpu/train/gan_trainer.py``: ``kd1``-``kd4``), each set with
  one mask per dropout op of the plan and a keep rate within 0.02 of the
  plan's ``1 - rate`` for each rate, pooled over the set's masks of that rate
  (a single 14-channel mask at batch 64 holds 896 draws, a standard error of
  0.013).
"""
import math

import jax
import numpy as np
import pytest
import torch
from test_torch_train_layers import attrs_for

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.core import convert
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

B, D_UPDATES, SEED = 64, 3, 0
MIN_KERNEL, STD_REL, STD_SE = 1000, 0.05, 4.0
EMBED_REL, Z_MEAN, Z_STD_REL, KEEP_TOL = 0.05, 0.02, 0.02, 0.02


@pytest.fixture(scope="module")
def jax_side():
    jtr = jgt.GANTrainer(jbigan.BiGAN(jbigan.mnist_bigan_config()),
                         jgt.GANTrainConfig(batch_size=B, d_updates_per_g_update=D_UPDATES))
    return jtr, jax.device_get(jtr.init_state(jax.random.PRNGKey(SEED)))


@pytest.fixture(scope="module")
def port_model():
    return tbigan.BiGAN(tbigan.mnist_bigan_config(), "cpu", torch.Generator().manual_seed(SEED))


def jax_tensors(st):
    return {"E": convert.encoder_state_dict_from_jax(st.params_E),
            "G": convert.generator_state_dict_from_jax(st.params_G),
            "D": convert.discriminator_state_dict_from_jax(st.vars_D["params"], st.vars_D["batch_stats"])}


def port_tensors(model):
    return {"E": model.encoder.state_dict(), "G": model.generator.state_dict(),
            "D": model.discriminator.state_dict()}


def test_every_tensor_has_the_jax_tensors_shape(jax_side, port_model):
    want, got = jax_tensors(jax_side[1]), port_tensors(port_model)
    for part in ("E", "G", "D"):
        assert set(got[part]) == set(want[part]), part
        for name, t in got[part].items():
            assert tuple(t.shape) == tuple(want[part][name].shape), f"{part}.{name}"


def test_initial_values_match_the_jax_distributions(jax_side, port_model):
    want, got = jax_tensors(jax_side[1]), port_tensors(port_model)
    kernels = 0
    for part in ("E", "G", "D"):
        for name, t in got[part].items():
            t, j = t.double(), want[part][name].double()
            where = f"{part}.{name}"
            if name.endswith("_kernel") and t.numel() >= MIN_KERNEL:
                tol = max(STD_REL, STD_SE / math.sqrt(t.numel()))
                assert abs(t.std().item() / j.std().item() - 1) <= tol, where
                kernels += 1
            elif name.endswith("_bias") or name.endswith(".bias") or name.endswith(".mean"):
                assert torch.all(t == 0) and torch.all(j == 0), where
            elif name.endswith(".scale") or name.endswith(".var"):
                assert torch.all(t == 1) and torch.all(j == 1), where
            elif ".embed_" in name:
                assert abs(t.std().item() - 1) <= EMBED_REL, where
                assert abs(j.std().item() - 1) <= EMBED_REL, where
    assert kernels == 20  # E 5, G 5, D 10: every conv and transposed conv kernel


def jax_dropout_keys(jtr, st):
    """The dropout keys the JAX step hands to D's train-mode forwards,
    counted while tracing the step (both branches of the E+G ``cond``)."""
    keys = []
    apply_d = jtr._apply_D

    def counting(params_d, batch_stats, x, z, attrs, rng, train=True):
        if train:
            keys.append(rng)
        return apply_d(params_d, batch_stats, x, z, attrs, rng, train)

    jtr._apply_D = counting
    try:
        rng = np.random.default_rng(SEED)
        batch = {"image": np.zeros((B, 28, 28, 1), np.float32),
                 "attrs": attrs_for(jtr.model.cfg.attr_spec, B, rng)}
        jax.eval_shape(jtr.train_step, st, batch)
    finally:
        jtr._apply_D = apply_d
    return keys


def test_one_step_draws_the_jax_steps_noise(jax_side, port_model):
    jtr, st = jax_side
    tr = GANTrainer(port_model, GANTrainConfig(batch_size=B, d_updates_per_g_update=D_UPDATES), "cpu", seed=SEED)
    drawn, took = [], []
    draw = tr.draw_noise
    tr.draw_noise = lambda b: drawn.append(draw(b)) or drawn[-1]
    tr.eg_update = lambda x, attrs, z, masks: took.append(("eg", z, *masks)) or torch.zeros(())
    tr.recompute = lambda x, attrs, z: (torch.zeros(B, 1, 1, 512), torch.zeros(B, 28, 28, 1))
    tr.d_update = lambda x, z, attrs, target, masks: took.append(("d", z, masks)) or (
        torch.zeros(()), torch.zeros(B, 1))
    rng = np.random.default_rng(SEED)
    attrs = {k: torch.from_numpy(v) for k, v in attrs_for(port_model.cfg.attr_spec, B, rng).items()}
    tr.train_step({"image": torch.from_numpy(rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)),
                   "attrs": attrs})
    assert len(drawn) == 1
    z, masks = drawn[0]
    assert [t[0] for t in took] == ["eg", "d", "d"]
    assert took[0][1] is z and took[2][1] is z  # the E+G phase's and the fake pair's z
    assert [m for t in took for m in t[2:]] == masks  # each drawn set goes to one D forward, in order
    assert tuple(z.shape) == (B, 1, 1, 512)
    assert abs(z.mean().item()) <= Z_MEAN and abs(z.std().item() - 1) <= Z_STD_REL

    assert len(masks) == len(jax_dropout_keys(jtr, st)) == 4
    D = port_model.discriminator
    specs = [rate for part in (D.dx, D.dz, D.dxz) for rate, _ in part.drop_specs]
    assert sorted(set(specs)) == [0.2, 0.5]
    for fwd in masks:
        assert len(fwd) == len(specs) == 10
        for rate in set(specs):
            kept = [m for m, r in zip(fwd, specs) if r == rate]
            keep = sum(m.sum().item() for m in kept) / sum(m.numel() for m in kept)
            assert abs(keep - (1 - rate)) <= KEEP_TOL, rate
