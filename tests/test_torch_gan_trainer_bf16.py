"""bfloat16 training: one step of the port's ``GANTrainer`` on the AudioMNIST
BiGAN at d = 2 (latent 32), ``compute_dtype=bfloat16``, against the JAX
``GANTrainer.train_step`` on the CPU, from identical float32 parameters and
the same batch and ``z`` (drawn from the key the JAX step derives). The
audio discriminator has no dropout, so a step draws no masks. The same step
in float32, on both sides, is the truth the bf16 steps are measured against.

The two bf16 steps round at different places: the port's recompute sends
the encoder trunk through ``fused_encoder``'s plain version, which
accumulates each layer in float32 and rounds once, where the JAX step's
``PlanSequential`` rounds the conv and then the bias, and the two
frameworks' bf16 convs and their backward round at other places. A bf16
gradient that sums many terms carries tens of ulps (2^-8 relative) of the
tensor's largest entry, in either package. Tolerances:

- the losses and the D scores: one bf16 ulp (2^-8 relative);
- the gradients (Adam's first moment after one step is ``(1 - b1) g``): per
  tensor, max |g_port - g_jax| within three times the JAX bf16 step's own
  max |g_jax - g_float32| (its rounding budget); and the port's step is a
  bf16 step: per tensor, max |g_port - g_float32| at least 1/16 ulp of the
  tensor's largest entry (the bf16 steps show 4 to 2,000 times that, a
  float32 step less than a fifth of it);
- the parameters after Adam (``p - lr * g / (|g| + eps)``, float32): where
  both gradients have one sign and exceed 1e-6, within 16 ulps of ``lr``;
  where the signs differ, JAX's gradient lies within the gradient tolerance
  of zero; nowhere further than ``2 * lr`` (D, updated twice: twice the
  two updates' longest, ``(1 + 1.054) * lr``).

The float32 steps meet ``test_torch_gan_trainer.py``'s tolerances. The file
also pins the bfloat16 semantics: parameters and both Adam states stay
float32, E's codes, G's images and D's logits come back float32 holding
bf16 values, the losses are float32; the recompute's weight casts follow the in-place Adam update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gan_trainer import as_tree, assert_state_close, to_torch
from test_torch_train_layers import attrs_for, redraw

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.core.convert import gan_state_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.ops import tensor_core
from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

LR, B, LATENT, ULP = 1e-4, 8, 32, 2.0 ** -8
B1, B2 = 0.5, 0.999  # the trainer's Adam betas
# the longest second Adam update, in units of lr: |mu_hat| / sqrt(nu_hat) at
# count 2 is at most sqrt(a^2 / c + b^2 / d) (Cauchy-Schwarz) for
# mu_hat = a g1 + b g2, nu_hat = c g1^2 + d g2^2
SECOND = np.sqrt(((1 - B1) * B1 / (1 - B1 ** 2)) ** 2 / ((1 - B2) * B2 / (1 - B2 ** 2))
                 + ((1 - B1) / (1 - B1 ** 2)) ** 2 / ((1 - B2) / (1 - B2 ** 2)))


def jax_trainer(seed, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    cfg = jbigan.audio_mnist_bigan_config(d=2, latent_dim=LATENT, compute_dtype=dtype)
    jtr = jgt.GANTrainer(jbigan.BiGAN(cfg), jgt.GANTrainConfig(batch_size=B))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    pE, pG, pD = (redraw(p, rng) for p in (st.params_E, st.params_G, st.vars_D["params"]))
    st = st.replace(params_E=pE, params_G=pG, vars_D={"params": pD, "batch_stats": {}},
                    opt_eg=jtr.tx_eg.init({"E": pE, "G": pG}), opt_d=jtr.tx_d.init(pD))
    return jtr, st, rng


def port_trainer(st, dtype=torch.bfloat16):
    cfg = tbigan.audio_mnist_bigan_config(d=2, latent_dim=LATENT, compute_dtype=dtype)
    tr = GANTrainer(tbigan.BiGAN(cfg, "cpu"), GANTrainConfig(batch_size=B), device="cpu")
    tr.load_state_dict(gan_state_from_jax(as_tree(st)))
    return tr


def batch_for(rng):
    return {"image": rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32),
            "attrs": attrs_for(tbigan.AUDIO_MNIST_SPEC, B, rng)}


@pytest.fixture(scope="module")
def steps():
    """One step from the same state, batch and ``z`` in each package and
    type: ``{dtype: (port trainer, its metrics, JAX state, JAX metrics)}``."""
    out = {}
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jtr, st0, rng = jax_trainer(0, jdt)
        batch = batch_for(rng)
        z = np.asarray(jax.random.normal(jax.random.split(st0.rng, 9)[1], (B, 1, 1, LATENT)))
        st1, ref = jax.jit(jtr.train_step)(st0, jax.tree_util.tree_map(jnp.asarray, batch))
        tr = port_trainer(st0, tdt)
        got = tr.train_step(to_torch(batch), z=torch.from_numpy(z), masks=[[]] * 4)
        out[tdt] = (tr, got, st1, ref)
    return out


def grads(state):
    """Each optimiser's gradients by name, read off Adam's first moment."""
    return {(opt, n): m.numpy() / (1 - B1) for opt in ("opt_eg", "opt_d")
            for n, m in state[opt]["mu"].items()}


def test_one_bf16_step_follows_jax(steps):
    tr, got, st, ref = steps[torch.bfloat16]
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=ULP, err_msg=k)
    want, have = gan_state_from_jax(as_tree(st)), tr.state_dict()
    truth = grads(gan_state_from_jax(as_tree(steps[torch.float32][2])))
    g_jax, g_port = grads(want), grads(have)
    tol = {}
    for key, gj in g_jax.items():
        top = np.abs(truth[key]).max()
        budget = np.abs(gj - truth[key]).max()
        err = np.abs(g_port[key] - gj).max()
        tol[key] = max(3 * budget, 1e-30)
        assert err <= tol[key], f"{key}: gradient off by {err:.3e}, JAX's own bf16 error {budget:.3e}"
        rounded = np.abs(g_port[key] - truth[key]).max()
        assert rounded >= ULP / 16 * top, f"{key}: the bf16 gradient is the float32 one ({rounded:.3e})"
    assert have["step"] == want["step"] == 1
    params = {"opt_eg": {**{f"E.{k}": ("E", k) for k in want["E"]}, **{f"G.{k}": ("G", k) for k in want["G"]}},
              "opt_d": {k: ("D", k) for k in want["D"]}}
    for opt, names in params.items():
        assert have[opt]["count"] == want[opt]["count"] == (1 if opt == "opt_eg" else 2)
        for name, (part, key) in names.items():
            h, w = have[part][key], want[part][key]
            assert h.dtype == torch.float32, name
            err = np.abs(h.numpy() - w.numpy())
            gp, gj = g_port[opt, name], g_jax[opt, name]
            # D takes two Adam updates a step, the second up to SECOND * lr
            # long, and its moment holds their mix: D is held to the bound alone
            bound = 2 * LR * ((1 + SECOND) if opt == "opt_d" else 1) * (1 + 1e-6)
            assert err.max() <= bound, f"{name}: {err.max()}"
            if opt == "opt_eg":
                same = (np.sign(gp) == np.sign(gj)) & (np.abs(gp) > 1e-6) & (np.abs(gj) > 1e-6)
                assert (err[same] <= 16 * ULP * LR).all(), f"{name}: an update of one sign differs"
                flipped = np.sign(gp) != np.sign(gj)
                assert (np.abs(gj[flipped]) <= tol[opt, name]).all(), f"{name}: a clear gradient's sign flipped"
    for opt in ("opt_eg", "opt_d"):
        assert {v.dtype for v in have[opt]["nu"].values()} == {torch.float32}
        assert {m.dtype for m in have[opt]["mu"].values()} == {torch.float32}


def test_one_float32_step_follows_jax(steps):
    tr, got, st, ref = steps[torch.float32]
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_state_close(tr, st, 1)


def test_bf16_forwards_return_float32(steps):
    tr = steps[torch.bfloat16][0]
    rng = np.random.default_rng(1)
    batch = to_torch(batch_for(rng))
    x, attrs = batch["image"], batch["attrs"]
    z = torch.randn(B, 1, 1, LATENT)
    m = tr.model
    ex, gz = m.encoder(x, attrs, train=True), m.generator(z, attrs, train=True)
    logits = m.discriminator(x, ex, attrs, train=True, masks=[])
    assert (ex.dtype, gz.dtype, logits.dtype) == (torch.float32,) * 3
    assert ex.requires_grad and gz.requires_grad
    # the bf16 values, returned exactly
    for out in (ex, gz, logits):
        assert torch.equal(out, out.to(torch.bfloat16).float())
    ex_k, _ = tr.recompute(x, attrs, z)
    assert ex_k.dtype == torch.float32 and not ex_k.requires_grad
    np.testing.assert_allclose(ex_k.numpy(), ex.detach().numpy(), rtol=8 * ULP,
                               atol=8 * ULP * float(ex.detach().abs().max()))


def test_recompute_casts_follow_the_adam_update():
    """The bf16 weight copies the recompute's kernel reads are cached per
    parameter; an Adam step moves every parameter in place, and the next
    recompute must see the new weights: its codes equal those of a trainer
    built fresh from the updated float32 parameters."""
    _, st, rng = jax_trainer(2)
    tr = port_trainer(st)
    batch = to_torch(batch_for(rng))
    x, attrs, z = batch["image"], batch["attrs"], torch.randn(B, 1, 1, LATENT)
    before, _ = tr.recompute(x, attrs, z)
    versions = {n: p._version for n, p in tr.model.encoder.trunk.named_parameters()}
    tr.train_step(batch, z=z, masks=[[]] * 4)
    assert all(p._version > versions[n] for n, p in tr.model.encoder.trunk.named_parameters())
    after, _ = tr.recompute(x, attrs, z)
    fresh = port_trainer(st)
    fresh.load_state_dict(tr.state_dict())
    tensor_core._CACHE.clear()
    want, _ = fresh.recompute(x, attrs, z)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)


@pytest.mark.parametrize("mu", ["float32", "bfloat16"])
def test_bf16_keeps_float32_parameters_and_adam_state(mu):
    _, st, rng = jax_trainer(3)
    cfg = tbigan.audio_mnist_bigan_config(d=2, latent_dim=LATENT, compute_dtype=torch.bfloat16)
    tr = GANTrainer(tbigan.BiGAN(cfg, "cpu"), GANTrainConfig(batch_size=B, mu_dtype=getattr(torch, mu)),
                    device="cpu")
    tr.load_state_dict(gan_state_from_jax(as_tree(st)))
    metrics = tr.train_step(to_torch(batch_for(rng)))
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in metrics.values())
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    for opt in (tr.opt_eg, tr.opt_d):
        assert opt.nu.dtype == torch.float32 and opt.mu.dtype == getattr(torch, mu)

