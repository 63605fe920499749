"""The collectives of one data-parallel training step (the counterpart of
``tests/test_collectives.py``): at 4 gloo ranks on the CPU, every
``torch.distributed`` call of one ``train_step`` of each trainer is recorded
(``parallel.launch.record_collectives``).

The data-parallel claim is: the batch sharded, the parameters replicated,
and the only traffic of a step the gradient all-reduce, one flat buffer an
optimiser update. So the all-reduced bytes over the gradient bytes must lie
in [0.98, 1.5] (the gradient bytes: E+G plus twice D for the BiGAN trainers'
one E+G update and two D updates, G plus D for the unconditional GAN, the
parameters once for the VAE and the classifier, E's for the fine-tuner; D's
batch-norm statistics, four floats a channel a forward with its backward,
ride along), and no step may broadcast, gather, scatter, reduce-scatter,
all-to-all, send or receive. The step's metrics are its shard's: no
per-step metric reduction is made (an epoch's totals are averaged once, at
its end). The BiGAN trainers are held at the four image sizes, MNIST 28²,
AudioMNIST 128², whale 256² and ESRF 512² (MNIST at full width, the others
at d = 2: the property is one of the program's structure, not of its
widths).
"""
import numpy as np
import pytest
import torch

from imagecfgen_torch.parallel.launch import record_collectives, run_ranks

WORLD = 4
BATCH = 8
BIGANS = ("mnist", "audio", "whale", "esrf")
TRAINERS = (*BIGANS, "vae", "classifier", "uncond_gan", "finetune")
KINDS_ALLOWED = {"all_reduce"}


def attrs_for(spec, n, rng):
    a = {s.name: np.eye(s.n_categories, dtype=np.float32)[rng.integers(0, s.n_categories, n)]
         for s in spec.categorical}
    a.update({s.name: rng.uniform(-1, 1, n).astype(np.float32) for s in spec.continuous})
    return {k: torch.from_numpy(v) for k, v in a.items()}


def config(name):
    from imagecfgen_torch.models import bigan

    if name == "mnist":
        return bigan.mnist_bigan_config()
    make = {"audio": bigan.audio_mnist_bigan_config, "whale": bigan.whale_bigan_config,
            "esrf": bigan.esrf_bigan_config}[name]
    return make(d=2, latent_dim=16)


def nbytes(params):
    return sum(p.numel() * p.element_size() for p in params)


def one_step(mesh, name):
    """``(collective log, gradient bytes)`` of one step of ``name``'s
    trainer on this rank."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    if name in BIGANS or name in ("vae", "finetune"):
        from imagecfgen_torch.cf.finetune import EncoderFinetuner, FinetuneConfig
        from imagecfgen_torch.models.bigan import BiGAN
        from imagecfgen_torch.models.vae import ConditionalVAE
        from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer
        from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

        cfg = config("mnist" if name in ("vae", "finetune") else name)
        h, w = cfg.image_size
        batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (BATCH, h, w, cfg.image_channels)).astype(np.float32)),
                 "attrs": attrs_for(cfg.attr_spec, BATCH, rng)}
        if name == "vae":
            tr = VAETrainer(ConditionalVAE(cfg, "cpu", gen), VAETrainConfig(batch_size=BATCH), "cpu", mesh=mesh)
            grads = nbytes(tr.params)
        elif name == "finetune":
            tr = EncoderFinetuner(BiGAN(cfg, "cpu", gen), FinetuneConfig(batch_size=BATCH), "cpu", mesh=mesh)
            grads = nbytes(tr.params)
        else:
            tr = GANTrainer(BiGAN(cfg, "cpu", gen), GANTrainConfig(batch_size=BATCH), "cpu", mesh=mesh)
            grads = nbytes(tr.params_eg) + 2 * nbytes(tr.params_d)
    elif name == "classifier":
        from imagecfgen_torch.models.classifier import CNNClassifier, mnist_classifier_config
        from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

        tr = SupervisedTrainer(CNNClassifier(mnist_classifier_config(), "cpu", gen),
                               SupervisedTrainConfig(batch_size=BATCH), "cpu", mesh=mesh)
        batch = {"x": torch.from_numpy(rng.uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)),
                 "y": torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)])}
        grads = nbytes(tr.params)
    else:
        from imagecfgen_torch.models.gan import UncondGANConfig
        from imagecfgen_torch.train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer

        tr = UncondGANTrainer(UncondGANConfig(d=2, latent_dim=16),
                              UncondGANTrainConfig(batch_size=BATCH, loss_mode="wgan"), "cpu", mesh=mesh)
        batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (BATCH, 128, 128, 1)).astype(np.float32))}
        grads = nbytes(tr.params_g) + nbytes(tr.params_d)
    with record_collectives() as log:
        tr.train_step(batch)
    return {"log": log, "grads": grads}


def all_steps(mesh):
    return {name: one_step(mesh, name) for name in TRAINERS}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(all_steps, WORLD, workdir=str(tmp_path_factory.mktemp("rdv")), timeout=300)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", TRAINERS)
def test_a_step_is_one_gradient_all_reduce_an_update(recorded, name):
    for rank, steps in enumerate(recorded):
        row = steps[name]
        log = row["log"]
        assert set(log) <= KINDS_ALLOWED, (name, rank, log)
        ratio = log["all_reduce"]["bytes"] / row["grads"]
        assert 0.98 <= ratio <= 1.5, (name, rank, ratio, log)
        assert log == recorded[0][name]["log"], "every rank issues the same collectives"
