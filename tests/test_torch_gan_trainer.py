"""The port's ``GANTrainer`` against the JAX ``GANTrainer.train_step``, on the
CPU, at a small size: from identical parameters and the same injected noise,
four steps with ``d_updates_per_g_update=2`` (so two steps update E and G and
two skip them) must follow the JAX trajectory.

Noise: ``z`` is drawn from the key the JAX step derives
(``jax.random.split(state.rng, 9)[1]``) and handed to the port; the dropout
masks are drawn with numpy and reach the JAX side through a stand-in for
``imagecfgen_tpu.models.layers.channel_dropout`` that reads them from a queue.
The JAX step runs under ``jax.disable_jit()`` so that it consumes the masks in
program order and a skipped E+G phase consumes none.

Tolerances. Adam's first updates are ``lr * g / |g|`` per element, so a
parameter's error after a step is ``lr`` times the relative error of its
gradient: parameters are held to 1e-5 relative plus ``0.02 * lr`` absolute
after one step and to four times that after four. An element whose gradient
is itself rounding noise (a sum that cancels) may take the update's other
sign, so up to one element in a thousand of a tensor may miss that, but none
by more than ``2 * lr`` per Adam update (two a step for D). The moments: 1e-4
relative plus 2e-5 of the tensor's largest entry (a gradient element that is
a sum with cancellation keeps the absolute error of its terms); the metrics
to 1e-5 relative.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_layers import (  # the same directory: shared test helpers
    MaskQueue,
    attrs_for,
    draw_masks,
    narrow_config,
    redraw,
)

from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import layers as jlayers
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.core.convert import gan_state_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.ops import fused_encoder
from imagecfgen_torch.train.gan_trainer import (
    GANTrainConfig,
    GANTrainer,
    bce_logits,
    make_epoch_batches,
)

LR = 1e-4
B = 8


def jax_state(domain, seed, tcfg_kwargs):
    """A JAX trainer and a ``GANState`` with redrawn O(1) parameters."""
    rng = np.random.default_rng(seed)
    jcfg = narrow_config(jbigan, domain)
    jtr = jgt.GANTrainer(jbigan.BiGAN(jcfg), jgt.GANTrainConfig(batch_size=B, **tcfg_kwargs))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    pE, pG = redraw(st.params_E, rng), redraw(st.params_G, rng)
    pD = redraw(st.vars_D["params"], rng)
    st = st.replace(
        params_E=pE, params_G=pG,
        vars_D={"params": pD, "batch_stats": jax.device_get(st.vars_D["batch_stats"])},
        opt_eg=jtr.tx_eg.init({"E": pE, "G": pG}), opt_d=jtr.tx_d.init(pD))
    return jtr, st, rng


def as_tree(st):
    """A JAX ``GANState`` as the numpy tree a checkpoint of it holds."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params_E": to_np(st.params_E), "params_G": to_np(st.params_G),
            "vars_D": to_np(st.vars_D), "step": np.asarray(st.step),
            "opt_eg": [dict(count=np.asarray(st.opt_eg[0].count), mu=to_np(st.opt_eg[0].mu),
                            nu=to_np(st.opt_eg[0].nu)), {}],
            "opt_d": [dict(count=np.asarray(st.opt_d[0].count), mu=to_np(st.opt_d[0].mu),
                           nu=to_np(st.opt_d[0].nu)), {}]}


def port_trainer(domain, st, **tcfg_kwargs):
    tr = GANTrainer(tbigan.BiGAN(narrow_config(tbigan, domain), "cpu"),
                    GANTrainConfig(batch_size=B, **tcfg_kwargs), device="cpu")
    tr.load_state_dict(gan_state_from_jax(as_tree(st)))
    return tr


def batch_for(cfg, rng):
    h, w = cfg.image_size
    return {"image": rng.uniform(-1, 1, (B, h, w, 1)).astype(np.float32),
            "attrs": attrs_for(cfg.attr_spec, B, rng)}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def assert_state_close(tr, st, steps):
    """The port trainer's whole state against the JAX state, by name."""
    ref, got = gan_state_from_jax(as_tree(st)), tr.state_dict()
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
                np.testing.assert_allclose(got[opt][moment][name].numpy(), want.numpy(), rtol=1e-4,
                                           atol=2e-5 * float(want.abs().max()),
                                           err_msg=f"{opt}.{moment}.{name}")


@pytest.mark.parametrize("domain,exact", [("mnist", False), ("mnist", True), ("audio", False)])
def test_four_steps_follow_jax(domain, exact, monkeypatch):
    kwargs = dict(d_updates_per_g_update=2, exact_reference_diagnostics=exact)
    jtr, st, rng = jax_state(domain, 0, kwargs)  # its init draws its own dropout keys
    queue = MaskQueue()
    monkeypatch.setattr(jlayers, "channel_dropout", queue)
    tr = port_trainer(domain, st, **kwargs)
    assert_state_close(tr, st, 0)
    D = tr.model.discriminator
    for step in range(4):
        batch = batch_for(tr.model.cfg, rng)
        do_eg = step % 2 == 0
        masks = [draw_masks(D, B, rng) for _ in range(6 if exact else 4)]
        z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (B, 1, 1, 32)))
        # the JAX step consumes: [E+G real, E+G fake,] D real, D fake[, D(G(z)), D(E(x))]
        queue.masks = [m for fwd in (masks if do_eg else masks[2:]) for m in fwd]
        with jax.disable_jit():
            st, ref = jtr.train_step(st, jax.tree_util.tree_map(jnp.asarray, batch))
        assert not queue.masks
        got = tr.train_step(to_torch(batch), z=torch.from_numpy(z),
                            masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} at step {step}")
        assert (got["loss_EG"].item() != 0.0) == do_eg
        if step == 0:
            assert_state_close(tr, st, 1)
    assert_state_close(tr, st, 4)
    assert tr.state_dict()["opt_d"]["count"] == 8 and tr.state_dict()["opt_eg"]["count"] == 2


def fresh_trainer(domain="mnist", seed=0, **kwargs):
    g = torch.Generator().manual_seed(seed)
    cfg = narrow_config(tbigan, domain)
    tr = GANTrainer(tbigan.BiGAN(cfg, "cpu", g), GANTrainConfig(batch_size=B, **kwargs),
                    device="cpu", seed=seed)
    with torch.no_grad():  # the configs' own init leaves every activation near zero
        for p in tr.model.parameters():
            if p.dim() > 1 and "embed" not in str(p.shape):
                p.mul_(1.0 / (p.std() * np.sqrt(p[0].numel())) if p.std() > 0 else 1.0)
    return tr


def test_no_parameter_is_left_without_a_gradient():
    tr = fresh_trainer()
    batch = to_torch(batch_for(tr.model.cfg, np.random.default_rng(0)))
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    stats = {n: b.clone() for n, b in tr.model.discriminator.named_buffers()}
    metrics = tr.train_step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    for n, p in tr.model.named_parameters():
        assert p.grad is not None, f"{n} ended the step without a gradient"
        assert not torch.equal(p, before[n]), f"{n} did not move"
    for n, b in tr.model.discriminator.named_buffers():
        assert not torch.equal(b, stats[n]), f"{n} did not move"
    assert tr.step == 1


def test_a_parameter_outside_the_loss_raises():
    """Adam skips a parameter whose ``grad`` is None without a word; the
    trainer's updates refuse one instead."""
    tr = fresh_trainer()
    batch = to_torch(batch_for(tr.model.cfg, np.random.default_rng(0)))
    orphan = torch.nn.Parameter(torch.zeros(3))
    tr.params_eg.append(orphan)
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        tr.train_step(batch)


def test_encoder_routing(monkeypatch):
    """The encoder differentiates its ``PlanSequential`` exactly when a
    gradient is recorded and needed, and takes the kernel's wrapper
    otherwise."""
    tr = fresh_trainer()
    enc = tr.model.encoder
    batch = to_torch(batch_for(tr.model.cfg, np.random.default_rng(0)))
    x, attrs = batch["image"], batch["attrs"]
    calls = []
    real = fused_encoder.fused_encoder_forward

    def record(*a, **k):
        calls.append("kernel")
        return real(*a, **k)

    monkeypatch.setattr(tbigan, "fused_encoder_forward", record)
    trunk_forward = enc.trunk.forward
    monkeypatch.setattr(enc.trunk, "forward", lambda *a, **k: (calls.append("plan"), trunk_forward(*a, **k))[1])

    z = enc(x, attrs)
    assert calls == ["plan"] and z.requires_grad
    z.sum().backward()
    assert all(p.grad is not None for p in enc.parameters())
    with torch.no_grad():
        z_kernel = enc(x, attrs)
    assert calls == ["plan", "kernel"] and not z_kernel.requires_grad
    np.testing.assert_allclose(z_kernel.numpy(), z.detach().numpy(), rtol=1e-5, atol=1e-5)
    for p in enc.parameters():
        p.requires_grad_(False)
    enc(x, attrs)                           # frozen parameters: serving's route
    assert calls[-1] == "kernel"
    enc(x.clone().requires_grad_(True), attrs)  # but a gradient to the input needs the plan
    assert calls[-1] == "plan"
    for p in enc.parameters():
        p.requires_grad_(True)
    calls.clear()
    tr.train_step(batch)                    # E+G update: plan; recompute: kernel
    assert calls == ["plan", "kernel"]


def test_the_kernel_wrapper_refuses_a_gradient_off_the_cpu():
    """On the CPU the plain version is differentiable; on any other device
    ``fused_encoder_forward`` raises when a gradient is asked of it (checked
    here on ``meta`` tensors, which need no card)."""
    cfg = narrow_config(tbigan, "mnist")
    enc = tbigan.Encoder(cfg, "cpu", torch.Generator().manual_seed(0))
    meta = {k: torch.nn.Parameter(torch.empty_like(v, device="meta"))
            for k, v in enc.trunk.named_parameters()}
    feats = torch.empty(2, 28, 28, 5, device="meta")
    with pytest.raises(ValueError, match="no backward"):
        fused_encoder.fused_encoder_forward(meta, feats, cfg.enc_plan)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device meta"):
        fused_encoder.fused_encoder_forward(meta, feats, cfg.enc_plan)
    frozen = {k: v.detach() for k, v in meta.items()}
    with pytest.raises(ValueError, match="no backward"):
        fused_encoder.fused_encoder_forward(frozen, feats.requires_grad_(True), cfg.enc_plan)
    cpu = dict(enc.trunk.named_parameters())
    out = fused_encoder.fused_encoder_forward(cpu, torch.randn(2, 28, 28, 5), cfg.enc_plan)
    out.sum().backward()
    assert all(p.grad is not None for p in cpu.values())


def test_remat_takes_the_same_step():
    """Rematerialised forwards change neither the update nor the running
    statistics (the second forward must not move them again)."""
    a, b = fresh_trainer(remat=False), fresh_trainer(remat=True)
    batch = to_torch(batch_for(a.model.cfg, np.random.default_rng(0)))
    ma, mb = a.train_step(batch), b.train_step(batch)
    for k in ma:
        np.testing.assert_allclose(ma[k].item(), mb[k].item(), rtol=1e-6)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name in sa:
        np.testing.assert_allclose(sa[name].numpy(), sb[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_epochs_run_on_device_resident_data_and_fetch_once(monkeypatch):
    tr = fresh_trainer(d_updates_per_g_update=3)
    rng = np.random.default_rng(0)
    n = 3 * B + 5  # a ragged tail
    cfg = tr.model.cfg
    x = rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32)
    attrs = attrs_for(cfg.attr_spec, n, rng)
    fetches = []
    item, tolist = torch.Tensor.item, torch.Tensor.tolist

    def spy_item(self):
        # torch.optim.Adam reads its own step count, which it keeps on the host
        if "/torch/optim/" not in sys._getframe(1).f_code.co_filename.replace("\\", "/"):
            fetches.append("item")
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: (fetches.append("tolist"), tolist(self))[1])
    metrics = tr.fit_epoch(tr.upload_dataset(x, attrs))
    assert fetches == ["tolist"]  # one fetch per epoch, none inside the step loop
    monkeypatch.undo()
    assert tr.step == 3 and set(metrics) == {"loss_EG", "loss_D", "D_score", "EG_score"}
    assert all(np.isfinite(v) for v in metrics.values())
    metrics = tr.run_epoch(make_epoch_batches(rng, x, attrs, B))
    assert tr.step == 6 and tr.state_dict()["opt_d"]["count"] == 12
    assert tr.state_dict()["opt_eg"]["count"] == 2  # steps 0 and 3
    with pytest.raises(ValueError, match="smaller than one batch"):
        tr.fit_epoch(tr.upload_dataset(x[:3], {k: v[:3] for k, v in attrs.items()}))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    model = tbigan.BiGAN(narrow_config(tbigan, "mnist"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GANTrainer(model, GANTrainConfig())
    assert GANTrainer(model, GANTrainConfig(), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="float32"):
        GANTrainer(tbigan.BiGAN(tbigan.mnist_bigan_config(32, torch.bfloat16), "cpu"),
                   GANTrainConfig(), device="cpu")


@pytest.mark.parametrize("target", [0, 1])
def test_bce_logits_matches_jax(target):
    x = np.random.default_rng(0).normal(0, 8, (16, 1)).astype(np.float32)
    np.testing.assert_allclose(bce_logits(torch.from_numpy(x), target).item(),
                               float(jgt.bce_logits(jnp.asarray(x), target)), rtol=1e-6)
    with pytest.raises(ValueError):
        bce_logits(torch.from_numpy(x), 2)


def test_torch_adam_is_optax_adam():
    """One parameter, five steps with the trainer's Adam settings."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 1, (7,)).astype(np.float32)
    grads = rng.normal(0, 1, (5, 7)).astype(np.float32)
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    w, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = torch.optim.Adam([p], lr=LR, betas=(0.5, 0.999), eps=1e-8)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt)
        w = optax.apply_updates(w, upd)
        p.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)
