"""One GAN step of the whale (256^2) and ESRF (512^2) BiGANs with remat on
(the E, G and D forwards recomputed in the backward pass), the port's
``GANTrainer`` against the JAX package's ``GANTrainer.train_step`` on the
CPU: d = 2, latent 32, batch 2, Adam betas (0.5, 0.9) as the marine CLIs
set them, from identical O(1) float32 parameters, on the same batch and the
``z`` the JAX step draws (the marine discriminators have no dropout, so a
step draws no masks).

Tolerances are ``tests/test_torch_gan_trainer.py``'s: the metrics to 1e-5
relative, the parameters after Adam within ``0.02 * lr`` (all but one
element in a thousand; every element within ``2 * lr``, D's ``4 * lr``),
both Adam moments to 1e-4 relative plus 2e-5 of the tensor's largest entry.
The step's encoder routes are pinned too: the remat E+G phase
differentiates E's ``PlanSequential``; the detached recompute is one
``fused_encoder_forward`` call a step.
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
from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

D, LATENT, B, BETAS = 2, 32, 2, (0.5, 0.9)


def jax_step(domain, seed):
    rng = np.random.default_rng(seed)
    cfg = getattr(jbigan, f"{domain}_bigan_config")(d=D, latent_dim=LATENT)
    jtr = jgt.GANTrainer(jbigan.BiGAN(cfg), jgt.GANTrainConfig(batch_size=B, betas=BETAS, remat=True))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    pE, pG, pD = (redraw(p, rng) for p in (st.params_E, st.params_G, st.vars_D["params"]))
    st = st.replace(params_E=pE, params_G=pG, vars_D={"params": pD, "batch_stats": {}},
                    opt_eg=jtr.tx_eg.init({"E": pE, "G": pG}), opt_d=jtr.tx_d.init(pD))
    h, w = cfg.image_size
    batch = {"image": rng.uniform(-1, 1, (B, h, w, 1)).astype(np.float32),
             "attrs": attrs_for(cfg.attr_spec, B, rng)}
    z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (B, 1, 1, LATENT)))
    st1, ref = jax.jit(jtr.train_step)(st, jax.tree_util.tree_map(jnp.asarray, batch))
    return st, batch, z, st1, ref


@pytest.mark.parametrize("domain", ["whale", "esrf"])
def test_one_remat_step_follows_jax(domain, monkeypatch):
    st0, batch, z, st1, ref = jax_step(domain, {"whale": 0, "esrf": 1}[domain])
    cfg = getattr(tbigan, f"{domain}_bigan_config")(d=D, latent_dim=LATENT)
    tr = GANTrainer(tbigan.BiGAN(cfg, "cpu"), GANTrainConfig(batch_size=B, betas=BETAS, remat=True), "cpu")
    tr.load_state_dict(gan_state_from_jax(as_tree(st0)))
    calls = []
    real = tbigan.fused_encoder_forward
    monkeypatch.setattr(tbigan, "fused_encoder_forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tr.train_step(to_torch(batch), z=torch.from_numpy(z), masks=[[]] * 4)
    assert len(calls) == 1  # the recompute; the remat E+G phase differentiates PlanSequential
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_state_close(tr, st1, 1)
    assert tr.state_dict()["opt_d"]["count"] == 2
