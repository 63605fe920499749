"""The AudioMNIST case of ``test_torch_gan_trainer.py``'s four steps (the
port's ``GANTrainer`` against the JAX ``GANTrainer.train_step`` on the CPU at
d = 4 and latent 32 on 128x128 inputs, from identical parameters and the same
injected noise, with that file's tolerances), and the trainer's parts at the
narrow MNIST size: the encoder's routing between its plan and the kernel's
wrapper, rematerialisation, epochs on device-resident data, and the
trainers' Adam against ``optax.adam``."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_gan_trainer import LR, B, batch_for, four_steps_follow_jax, fresh_trainer, to_torch
from test_torch_train_layers import attrs_for

from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.ops import fused_encoder
from imagecfgen_torch.train.gan_trainer import make_epoch_batches
from imagecfgen_torch.train.optim import Adam


@pytest.mark.parametrize("domain,exact", [("audio", False)])
def test_four_steps_follow_jax(domain, exact, monkeypatch):
    four_steps_follow_jax(domain, exact, monkeypatch)


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

    monkeypatch.setattr(torch.Tensor, "item", lambda self: (fetches.append("item"), item(self))[1])
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


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_torch_adam_is_optax_adam(mu_dtype):
    """The trainers' ``train/optim.py::Adam`` against ``optax.adam`` with the
    GAN trainer's settings: three parameters of different shapes in one
    optimiser (cut from its flat buffers), five steps; the parameters and
    ``nu`` to float32 rounding, a bfloat16 ``mu`` to one of its ulps."""
    shapes = [(3, 4), (7,), (2, 2, 3)]
    rng = np.random.default_rng(0)
    w0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(5)]
    tx = optax.adam(LR, b1=0.5, b2=0.999, mu_dtype=getattr(jnp, mu_dtype))
    w = [jnp.asarray(v) for v in w0]
    opt = tx.init(w)
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in w0]
    topt = Adam(ps, LR, (0.5, 0.999), mu_dtype=getattr(torch, mu_dtype))
    for g in grads:
        upd, opt = tx.update([jnp.asarray(v) for v in g], opt)
        w = optax.apply_updates(w, upd)
        for p, v in zip(ps, g):
            p.grad = torch.from_numpy(v.copy())
        topt.step()
    mu, nu = topt.moments()
    assert topt.count == int(opt[0].count) == 5
    for i, p in enumerate(ps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w[i]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(nu[i].numpy(), np.asarray(opt[0].nu[i]), rtol=1e-6, atol=1e-12)
        want = np.asarray(opt[0].mu[i].astype(jnp.float32))
        assert mu[i].dtype == getattr(torch, mu_dtype)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        np.testing.assert_array_less(np.abs(mu[i].float().numpy() - want),
                                     ulp * 1.001 if mu_dtype == "bfloat16" else 1e-6 * np.abs(want) + 1e-12)
