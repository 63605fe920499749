"""The GAN trainer's opt-in modes against the JAX ``GANTrainer`` on the CPU, at
a small size: each mode alone, and the three that ``--throughput`` sets
together, follows the JAX trajectory for four steps with
``d_updates_per_g_update=2`` from identical parameters and injected noise.

Noise: ``z`` comes from the key the JAX step derives
(``jax.random.split(state.rng, 9)[1]``); the dropout masks are drawn with
numpy at the batches of ``GANTrainer.d_batches`` (2B for a fused D forward)
and reach the JAX side through a stand-in for ``channel_dropout`` that takes
them from a queue. The JAX step is jitted once a mode with the masks as its
arguments: tracing consumes them in program order, the E+G phase's first
(``lax.cond`` traces that branch whether or not a step takes it).

Tolerances, those of ``test_torch_gan_trainer.py``: parameters 1e-5 relative
plus 0.02·lr absolute a step for 99.9 % of each tensor and 2·lr an Adam
update for all of it; running statistics 1e-5·steps relative and 1e-6·steps
absolute; moments 1e-4 relative plus 2e-5 of the tensor's largest entry; the
metrics 1e-5 relative. A bfloat16 ``mu`` may also differ by one bfloat16 ulp
a rounding: two float32 values that differ in their last bits can round to
neighbouring bfloat16 values, and each later update carries that difference
on, times b1. So an element is held to ulp(the largest |mu| it held) / (1 -
b1), two ulps at b1 = 0.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_gan_trainer import B, LR, batch_for, jax_state, to_torch
from test_torch_train_layers import MaskQueue, draw_masks, narrow_config

from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_SPEC
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.models import layers as jlayers
from imagecfgen_torch.cli.common import load_bigan
from imagecfgen_torch.core.checkpoint import restore_sequences
from imagecfgen_torch.core.convert import gan_state_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

STEPS = 4
MODES = {  # (JAX GANTrainConfig fields, the port's)
    "fused_eg_d": ({"fused_eg_d": True}, {"fused_eg_d": True}),
    "fused_d_steps": ({"fused_d_steps": True}, {"fused_d_steps": True}),
    "mu_bf16": ({"mu_dtype": jnp.bfloat16}, {"mu_dtype": torch.bfloat16}),
    # the port's Adam always keeps its moments flat: it follows the JAX mode
    "flat_adam": ({"flat_adam": True}, {}),
    "throughput": ({"fused_d_steps": True, "fused_eg_d": True, "mu_dtype": jnp.bfloat16},
                   {"fused_d_steps": True, "fused_eg_d": True, "mu_dtype": torch.bfloat16}),
}


def jax_tree(st):
    """A JAX ``GANState`` as the numpy tree a checkpoint of it holds."""
    tree = {"params_E": st.params_E, "params_G": st.params_G, "vars_D": st.vars_D,
            "opt_eg": st.opt_eg, "opt_d": st.opt_d, "step": st.step}
    return restore_sequences(jax.device_get(serialization.to_state_dict(tree)))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def track_mu(seen, st):
    """The largest |mu| each element of the JAX state has held so far."""
    ref = gan_state_from_jax(jax_tree(st))
    for opt in ("opt_eg", "opt_d"):
        for name, m in ref[opt]["mu"].items():
            seen[opt, name] = np.maximum(seen.get((opt, name), 0.0), np.abs(m.numpy()))
    return seen


def assert_state_close(tr, st, steps, bf16_mu, seen=None):
    """``seen``: :func:`track_mu`'s record, which sets a bfloat16 ``mu``'s
    bound."""
    ref, got = gan_state_from_jax(jax_tree(st)), tr.state_dict()
    assert got["step"] == ref["step"] == steps
    for part in ("E", "G", "D"):
        assert set(got[part]) == set(ref[part])
        for name, want in ref[part].items():
            have, want = got[part][name].detach().numpy(), want.numpy()
            msg = f"{part}.{name} after {steps} steps"
            if name.endswith((".mean", ".var")):
                np.testing.assert_allclose(have, want, rtol=1e-5 * steps, atol=1e-6 * steps, err_msg=msg)
                continue
            err = np.abs(have - want)
            tight = err <= 0.02 * LR * steps + 1e-5 * steps * np.abs(want)
            assert tight.mean() >= 0.999, f"{msg}: {(~tight).sum()} of {tight.size} elements off"
            assert err.max() <= 2 * LR * steps * (2 if part == "D" else 1), f"{msg}: off by {err.max()}"
    for opt in ("opt_eg", "opt_d"):
        assert got[opt]["count"] == ref[opt]["count"]
        for moment in ("mu", "nu"):
            assert set(got[opt][moment]) == set(ref[opt][moment])
            for name, want in ref[opt][moment].items():
                have, want = got[opt][moment][name], want.numpy()
                bf16 = bf16_mu and moment == "mu"
                assert have.dtype == (torch.bfloat16 if bf16 else torch.float32)
                err = np.abs(have.float().numpy() - want)
                tol = 1e-4 * np.abs(want) + 2e-5 * np.abs(want).max()
                if bf16:
                    tol = tol + bf16_ulp(seen[opt, name]) / (1 - 0.5)
                assert (err <= tol).all(), f"{opt}.{moment}.{name}: off by {err.max()}"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_four_steps_follow_jax(mode, monkeypatch, tmp_path):
    jkw, tkw = MODES[mode]
    kwargs = dict(d_updates_per_g_update=2)
    jtr, st, rng = jax_state("mnist", 0, {**kwargs, **jkw})
    queue = MaskQueue()
    monkeypatch.setattr(jlayers, "channel_dropout", queue)

    def step(st, batch, masks):
        queue.masks = list(masks)  # tracers, taken in program order
        out = jtr.train_step(st, batch)
        assert not queue.masks
        return out

    jstep = jax.jit(step)
    tr = GANTrainer(tbigan.BiGAN(narrow_config(tbigan, "mnist"), "cpu"),
                    GANTrainConfig(batch_size=B, **kwargs, **tkw), device="cpu")
    tr.load_state_dict(gan_state_from_jax(jax_tree(st)))
    seen = track_mu({}, st)
    assert_state_close(tr, st, 0, "mu_dtype" in tkw, seen)
    D = tr.model.discriminator
    sizes = tr.d_batches(B)
    assert sizes == [2 * B if tkw.get("fused_eg_d") else B] * (1 if tkw.get("fused_eg_d") else 2) + \
        [2 * B if tkw.get("fused_d_steps") else B] * (1 if tkw.get("fused_d_steps") else 2)
    for i in range(STEPS):
        batch = batch_for(tr.model.cfg, rng)
        masks = [draw_masks(D, n, rng) for n in sizes]
        z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (B, 1, 1, 32)))
        st, ref = jstep(st, jax.tree_util.tree_map(jnp.asarray, batch),
                        [jnp.asarray(m) for fwd in masks for m in fwd])
        got = tr.train_step(to_torch(batch), z=torch.from_numpy(z),
                            masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
        for k in ref:
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
        assert (got["loss_EG"].item() != 0.0) == (i % 2 == 0)
        track_mu(seen, st)
    assert_state_close(tr, st, STEPS, "mu_dtype" in tkw, seen)
    d_per_step = 1 if tkw.get("fused_d_steps") else 2
    assert tr.state_dict()["opt_d"]["count"] == d_per_step * STEPS
    assert tr.state_dict()["opt_eg"]["count"] == STEPS // 2

    # the JAX CLI's file of this state loads into a fresh port trainer of the mode
    path = str(tmp_path / "mnist-bigan.tar")
    raw = {"thickness": rng.uniform(1, 5, 16), "intensity": rng.uniform(64, 255, 16),
           "slant": rng.uniform(-1, 1, 16), "digit": np.eye(10)[rng.integers(0, 10, 16)]}
    jcommon.save_bigan(path, st, JScaler.fit(J_SPEC, raw))
    state, scaler, meta = load_bigan(path, "cpu")
    assert meta["kind"] == "bigan" and state["rng"] is None
    assert scaler.mins["thickness"] == np.float32(raw["thickness"].min())
    fresh = GANTrainer(tbigan.BiGAN(narrow_config(tbigan, "mnist"), "cpu"),
                       GANTrainConfig(batch_size=B, **kwargs, **tkw), device="cpu")
    fresh.load_state_dict(state)
    ref, have = gan_state_from_jax(jax_tree(st)), fresh.state_dict()
    for part in ("E", "G", "D"):
        for name, t in ref[part].items():
            assert torch.equal(have[part][name], t), f"{part}.{name}"
    for opt in ("opt_eg", "opt_d"):
        assert have[opt]["count"] == ref[opt]["count"]
        for moment in ("mu", "nu"):
            for name, t in ref[opt][moment].items():
                assert torch.equal(have[opt][moment][name].float(), t), f"{opt}.{moment}.{name}"

def test_adam_refuses_another_parameter_list():
    from imagecfgen_torch.train.optim import Adam, adam_state

    p, q = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="not the optimiser's"):
        adam_state(Adam([p], 1e-3, (0.9, 0.999)), [("q", q)])
