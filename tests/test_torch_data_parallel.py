"""Data parallelism in the port's five trainers: 4 gloo ranks on the CPU
against 1 process with no group, on the same global batches (the
counterparts of the JAX package's 1-vs-8-device tests,
``tests/test_trainers.py:28-50,160-280``).

Each case builds its trainer from seeds and numpy data made inside the
rank, so every rank and the reference start alike; the reference is the
same function run here with ``data_mesh(None)``. Tolerances are the JAX
tests': loss trajectories to rtol 2e-3 and atol 2e-4 (a sum over the
global batch split into four partial sums differs in its last bits), and
parameters too, but for one element in a thousand of the model's, and
none may miss by more than ``2 lr`` an Adam update: Adam's update is
``lr g / |g|`` per element, and the sign of a gradient that is rounding noise
(a sum that cancels) follows the order of the sum (the audio case: 165 of
1,993,730 elements off, by up to 4.6e-4 after 8 updates at lr 1e-4);
``SpectStats`` on the sharded spectrograms to 1e-6 (mean) and 1e-4
(std: the pad column's std is rounding noise). Every rank's generator must
end in the reference's state (the noise is drawn for the global batch on
every rank). A gloo group of one rank must give the no-group numbers bit
for bit. The 4-rank MNIST ``train_step``, fed noise for the global batch,
is held against the JAX ``train_step`` on the same noise at rtol 1e-4.

The rank functions import no JAX (the ranks are spawned and import this
module); each rank runs on one host thread and the spawn is joined with a
timeout.
"""
import dataclasses

import numpy as np
import pytest
import torch

from imagecfgen_torch.parallel.launch import run_ranks
from imagecfgen_torch.parallel.mesh import data_mesh

WORLD = 4
TOL = dict(rtol=2e-3, atol=2e-4)
LR = 1e-4  # the BiGAN trainers' learning rate


def narrow_plan(plan, factor, keep_last=True):
    """Every conv's channel count divided by ``factor`` (the last conv keeps
    its own when ``keep_last``): ``test_torch_train_layers.narrow_plan``."""
    convs = [i for i, op in enumerate(plan) if op[0] in ("conv", "convT")]
    return tuple((op[0], max(op[1] // factor, 1), *op[2:])
                 if op[0] in ("conv", "convT") and not (keep_last and i == convs[-1]) else op
                 for i, op in enumerate(plan))


def narrow_config(mod):
    """``test_torch_train_layers.narrow_config(mod, "mnist")``: every width
    an eighth, latent 32, from either package's ``mnist_bigan_config``."""
    cfg = mod.mnist_bigan_config(latent_dim=32)
    return dataclasses.replace(
        cfg, enc_plan=narrow_plan(cfg.enc_plan, 8), gen_plan=narrow_plan(cfg.gen_plan, 8),
        dx_plan=narrow_plan(cfg.dx_plan, 8, keep_last=False),
        dz_plan=narrow_plan(cfg.dz_plan, 8, keep_last=False), dxz_plan=narrow_plan(cfg.dxz_plan, 8))


def mnist_data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32)
    a = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]}
    a.update({k: rng.uniform(-1, 1, n).astype(np.float32) for k in ("thickness", "intensity", "slant")})
    return x, a


def fan_in(module):
    """Kernels rescaled to unit fan-in variance (the configs' own init leaves
    every activation near zero), as ``test_torch_gan_trainer.fresh_trainer``."""
    with torch.no_grad():
        for n, p in module.named_parameters():
            if p.dim() > 1 and "embed" not in n and p.std() > 0:
                p.mul_(1.0 / (p.std() * np.sqrt(p[0].numel())))
    return module


def bigan_trainer(mesh, cfg=None, **tcfg):
    from imagecfgen_torch.models.bigan import BiGAN
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    from imagecfgen_torch.models import bigan

    cfg = cfg or narrow_config(bigan)
    model = fan_in(BiGAN(cfg, "cpu", torch.Generator().manual_seed(0)))
    return GANTrainer(model, GANTrainConfig(**tcfg), "cpu", seed=1, mesh=mesh)


def gan_epochs(trainer, data, epochs):
    traj = [list(trainer.fit_epoch(data).values()) for _ in range(epochs)]
    state = trainer.state_dict()
    return {"traj": np.asarray(traj), "params": {f"{k}.{n}": v for k in "EGD" for n, v in state[k].items()},
            "rng": trainer.rng.get_state(), "lr": trainer.tcfg.learning_rate, "updates": trainer.opt_d.count}


def run_case(mesh, case):
    """One trainer's run on ``mesh``: its metrics a epoch (``traj``), its
    parameters and buffers, its generator's state, its learning rate and its
    most Adam updates of one parameter (and ``stats``)."""
    if case in ("mnist_bigan", "mnist_bigan_throughput"):
        modes = dict(fused_d_steps=True, fused_eg_d=True) if case.endswith("throughput") else {}
        tr = bigan_trainer(mesh, batch_size=16, d_updates_per_g_update=2, **modes)
        return gan_epochs(tr, tr.upload_dataset(*mnist_data(64, 0)), 3)
    if case == "audio_bigan":
        from imagecfgen_torch.data.audio_mnist import spectrogram_batch
        from imagecfgen_torch.models.bigan import audio_mnist_bigan_config
        from imagecfgen_torch.ops.spectral import SpectStats
        from imagecfgen_torch.scm.audio_mnist import CARDINALITIES

        rng = np.random.default_rng(3)
        n = 16
        waves = torch.from_numpy(rng.normal(0, 0.3, (n, 8000)).astype(np.float32))
        attrs = {k: np.eye(c, dtype=np.float32)[rng.integers(0, c, n)] for k, c in CARDINALITIES.items()}
        spects = spectrogram_batch(waves)
        stats = SpectStats.compute(mesh.shard(spects), mesh)  # a reduction over the ranks
        imgs = stats.spect_to_img(spects)[:, :128, :128, None]
        tr = bigan_trainer(mesh, audio_mnist_bigan_config(d=2, latent_dim=16), batch_size=8, betas=(0.5, 0.9))
        out = gan_epochs(tr, tr.upload_dataset(imgs, attrs), 2)
        return {**out, "stats": {"mean": stats.mean, "std": stats.std}}
    if case == "vae":
        from imagecfgen_torch.models.vae import ConditionalVAE
        from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

        from imagecfgen_torch.models import bigan

        cfg = dataclasses.replace(narrow_config(bigan), init_std=1e-2)
        tr = VAETrainer(ConditionalVAE(cfg, "cpu", torch.Generator().manual_seed(0)),
                        VAETrainConfig(batch_size=16, kl_weight=1.0), "cpu", seed=1, mesh=mesh)
        x, a = mnist_data(32, 0)
        batches = {"image": x.reshape(2, 16, 28, 28, 1), "attrs": {k: v.reshape(2, 16, *v.shape[1:])
                                                                   for k, v in a.items()}}
        traj = [tr.run_epoch(batches)["neg_elbo"] for _ in range(3)]
        return {"traj": np.asarray(traj), "params": tr.model.state_dict(), "rng": tr.rng.get_state(),
                "lr": tr.tcfg.learning_rate, "updates": tr.opt.count}
    if case == "classifier":
        from imagecfgen_torch.models.classifier import CNNClassifier, mnist_classifier_config
        from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

        rng = np.random.default_rng(5)
        x = rng.uniform(-1, 1, (64, 28, 28, 1)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
        tr = SupervisedTrainer(CNNClassifier(mnist_classifier_config(), "cpu", torch.Generator().manual_seed(0)),
                               SupervisedTrainConfig(batch_size=16), "cpu", seed=1, mesh=mesh)
        data = tr.upload_dataset(x, y)
        traj = [tr.fit_epoch(data)["loss"] for _ in range(3)]
        return {"traj": np.asarray(traj), "params": tr.module.state_dict(), "rng": tr.rng.get_state(),
                "lr": tr.tcfg.learning_rate, "updates": tr.opt.count}
    if case in ("uncond_gan", "uncond_wgan"):
        from imagecfgen_torch.models.gan import UncondGANConfig
        from imagecfgen_torch.train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer

        x = np.random.default_rng(6).uniform(-1, 1, (32, 128, 128, 1)).astype(np.float32)
        mode = dict(loss_mode="wgan", discriminator_weight_decay=1e-2) if case == "uncond_wgan" else {}
        tr = UncondGANTrainer(UncondGANConfig(d=2, latent_dim=16), UncondGANTrainConfig(batch_size=16, **mode),
                              "cpu", seed=0, mesh=mesh)
        data = tr.upload_dataset(x)
        traj = [list(tr.fit_epoch(data).values()) for _ in range(3)]
        return {"traj": np.asarray(traj), "params": {**{f"G.{k}": v for k, v in tr.G.state_dict().items()},
                                                      **{f"D.{k}": v for k, v in tr.D.state_dict().items()}},
                "rng": tr.rng.get_state(), "lr": tr.tcfg.learning_rate, "updates": tr.opt_d.count}
    if case == "finetune":
        from imagecfgen_torch.cf.finetune import EncoderFinetuner, FinetuneConfig
        from imagecfgen_torch.models.bigan import BiGAN

        from imagecfgen_torch.models import bigan

        model = fan_in(BiGAN(narrow_config(bigan), "cpu", torch.Generator().manual_seed(0)))
        ft = EncoderFinetuner(model, FinetuneConfig(learning_rate=1e-3, batch_size=8, metric="ssim"), "cpu",
                              seed=1, mesh=mesh)
        data = ft.upload_dataset(*mnist_data(32, 2))
        perm = torch.from_numpy(np.random.default_rng(9).permutation(32))  # an explicit, global order
        traj = [list(ft.fit_epoch(data).values()), list(ft.fit_epoch(data, perm).values())]
        return {"traj": np.asarray(traj), "params": model.state_dict(), "rng": ft.rng.get_state(),
                "lr": ft.fcfg.learning_rate, "updates": ft.opt.count}
    raise ValueError(case)


CASES = ["mnist_bigan", "mnist_bigan_throughput", "audio_bigan", "vae", "classifier", "uncond_gan",
         "uncond_wgan", "finetune"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_equal_one(case, tmp_path):
    ref = run_case(data_mesh(None), case)
    ranks = run_ranks(run_case, WORLD, case, workdir=str(tmp_path), timeout=240)
    assert np.isfinite(ref["traj"]).all()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["traj"], ref["traj"], **TOL, err_msg=f"{case}: rank {r}'s metrics")
        assert set(got["params"]) == set(ref["params"])
        misses, size = 0, 0
        for name, want in ref["params"].items():
            want = want.numpy()
            err = np.abs(got["params"][name] - want)
            misses += int((err > TOL["atol"] + TOL["rtol"] * np.abs(want)).sum())
            size += want.size
            assert err.max() <= 2 * ref["lr"] * ref["updates"], f"{case}: {name}, rank {r}: off by {err.max():.3g}"
        assert misses <= size / 1000, f"{case}: rank {r}: {misses} of {size} elements off"
        assert np.array_equal(got["rng"], ref["rng"].numpy()), f"{case}: rank {r}'s generator drifted"
    for name in ranks[0]["params"]:  # the ranks hold one model
        assert all(np.array_equal(got["params"][name], ranks[0]["params"][name]) for got in ranks), name
    if "stats" in ref:
        for got in ranks:
            np.testing.assert_allclose(got["stats"]["mean"], ref["stats"]["mean"].numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(got["stats"]["std"], ref["stats"]["std"].numpy(), rtol=0, atol=1e-4)


def test_a_group_of_one_rank_is_no_group_bit_for_bit(tmp_path):
    """With every collective issued over a group of one rank (the gradient
    all-reduces, the batch-norm statistics, the epoch totals), the MNIST
    BiGAN trains exactly as with no group."""
    ref = run_case(data_mesh(None), "mnist_bigan")
    (got,) = run_ranks(run_case, 1, "mnist_bigan", workdir=str(tmp_path), timeout=120)
    assert np.array_equal(got["traj"], ref["traj"])
    for name, want in ref["params"].items():
        assert np.array_equal(got["params"][name], want.numpy()), name


def step_rank(mesh, init_state, batch, z, masks):
    """One ``train_step`` of the narrow MNIST BiGAN from a converted JAX
    state, on the global batch and noise: the rank's state after it and its
    shard's metrics."""
    from imagecfgen_torch.models import bigan
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    tr = GANTrainer(bigan.BiGAN(narrow_config(bigan), "cpu"), GANTrainConfig(batch_size=len(z)), "cpu", mesh=mesh)
    tr.load_state_dict(init_state)
    t = torch.from_numpy
    m = tr.train_step({"image": t(batch["image"]), "attrs": {k: t(v) for k, v in batch["attrs"].items()}},
                      z=t(z), masks=[[t(k) for k in fwd] for fwd in masks])
    state = tr.state_dict()
    return {"metrics": {k: v.item() for k, v in m.items()},
            "params": {f"{p}.{n}": v for p in "EGD" for n, v in state[p].items()}}


def test_four_rank_step_follows_jax(tmp_path, monkeypatch):
    """The port's MNIST ``train_step`` on 4 ranks against the JAX
    ``train_step`` (one process) from the same parameters, with the JAX
    step's ``z`` and the same dropout masks injected for the global batch:
    each metric's mean over the ranks (their shards' means) and every
    parameter and running statistic to rtol 1e-4, plus ``0.02 lr`` absolute:
    Adam's first update is ``lr g / (|g| + eps)``, so an element whose
    gradient is a sum that cancels moves by a share of ``lr`` that its
    rounding sets (2 of G's 167,616 first-layer elements moved 0.0093 lr
    apart)."""
    import jax
    import jax.numpy as jnp
    from test_torch_gan_trainer import as_tree, jax_state
    from test_torch_train_layers import MaskQueue, attrs_for, draw_masks

    from imagecfgen_tpu.models import layers as jlayers
    from imagecfgen_torch.core.convert import gan_state_from_jax
    from imagecfgen_torch.models import bigan as tbigan

    b = 8
    jtr, st, rng = jax_state("mnist", 0, {})
    init = gan_state_from_jax(as_tree(st))
    D = tbigan.BiGAN(narrow_config(tbigan), "cpu").discriminator
    batch = {"image": rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32),
             "attrs": attrs_for(narrow_config(tbigan).attr_spec, b, rng)}
    masks = [draw_masks(D, b, rng) for _ in range(4)]
    z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (b, 1, 1, 32)))
    queue = MaskQueue()
    monkeypatch.setattr(jlayers, "channel_dropout", queue)

    def step(st, batch, masks):  # jitted: tracing takes the masks in program order
        queue.masks = list(masks)
        out = jtr.train_step(st, batch)
        assert not queue.masks
        return out

    st, ref = jax.jit(step)(st, jax.tree_util.tree_map(jnp.asarray, batch),
                            [jnp.asarray(m) for fwd in masks for m in fwd])
    want = gan_state_from_jax(as_tree(st))
    ranks = run_ranks(step_rank, WORLD, init, batch, z, masks, workdir=str(tmp_path), timeout=120)
    for k in ref:
        got = np.mean([r["metrics"][k] for r in ranks])
        np.testing.assert_allclose(got, float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for part in "EGD":
        for name, w in want[part].items():
            for r in ranks:
                np.testing.assert_allclose(r["params"][f"{part}.{name}"], w.numpy(), rtol=1e-4, atol=0.02 * LR,
                                           err_msg=f"{part}.{name}")
