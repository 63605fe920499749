"""Train the 512^2 ESRF acoustic BiGAN (port of ``train_esrf_bigan.py``).

    python -m imagecfgen_torch.cli.train_esrf_bigan [--wav-dir W --label-csv L] [--output-path O] \
        [--steps 500] [--d 64] [--batch-size 16] [--max-batches N] [--no-remat] [--init-std S] \
        [--start-model M] [--resume] [--checkpoint-every 5] [--device cuda|cpu]

``--steps`` counts epochs. The training windows (at most ``--max-batches``
batches of 32 recordings' windows) become spectrograms once on the device,
normalised with their per-column statistics and kept there; Adam(1e-4,
betas 0.5 and 0.9), one D update pair a step, the E, G and D forwards
recomputed in the backward pass (``--remat``, on by default); each step's
detached ``E(x)`` runs in the ``fused_encoder`` kernel on the card.
``--start-model`` takes E, G and D from a BiGAN file of either package.
``esrf-bigan.tar`` holds the trainer's whole state (so ``--resume``
continues it bit for bit on the same device), the statistics, ``d`` and the
epoch; ``--resume`` also takes over a file that the JAX package wrote, which
carries no generator: the run draws its noise anew from ``--seed``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--wav-dir", "--data-dir", type=str, default=None)
parser.add_argument("--label-csv", "--labels", type=str, default=None)
parser.add_argument("--steps", "--epochs", type=int, default=500, help="epochs")
parser.add_argument("--batch-size", type=int, default=16)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--checkpoint-every", type=int, default=5)
parser.add_argument("--start-model", type=str, default=None)
parser.add_argument("--d", type=int, default=64)
parser.add_argument("--max-batches", type=int, default=None,
                    help="cap the data collection (512^2 windows are large)")
parser.add_argument("--remat", action="store_true", default=True,
                    help="recompute the forwards in the backward pass (fewer live activations)")
parser.add_argument("--no-remat", dest="remat", action="store_false")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--init-std", type=float, default=None,
                    help="conv init std override (the config's 0.001 by default, which sits at "
                         "D = 0.5 for many steps; 0.01 escapes within one epoch)")
parser.add_argument("--synthetic-recordings", type=int, default=24,
                    help="recordings of the synthetic stand-in (when --wav-dir is absent); a "
                         "boat-positive recording gives 10 windows, a negative one 1")
parser.add_argument("--resume", action="store_true",
                    help="continue from an existing esrf-bigan.tar in --output-path")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import dataclasses

    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import fit_gan_epochs, warm_start
    from .whale_common import collect_esrf_spectrograms, load_esrf_dataset, load_whale_bigan, save_whale_bigan
    from ..models import bigan
    from ..ops.spectral import SpectStats
    from ..train.gan_trainer import GANTrainConfig, GANTrainer

    data = load_esrf_dataset(args.wav_dir, args.label_csv, args.synthetic_recordings)
    spects, attrs = collect_esrf_spectrograms(data, args.max_batches, device)
    stats = SpectStats.compute(spects)
    x = stats.spect_to_img(spects)[..., None]
    del spects
    print(f"training on {len(x)} 512x512 windows")

    cfg = bigan.esrf_bigan_config(d=args.d)
    if args.init_std is not None:
        cfg = dataclasses.replace(cfg, init_std=args.init_std)
    trainer = GANTrainer(
        bigan.BiGAN(cfg, device, torch.Generator().manual_seed(args.seed)),
        GANTrainConfig(learning_rate=args.l_rate, betas=(0.5, 0.9), batch_size=args.batch_size,
                       remat=args.remat),
        device, seed=args.seed, mesh=mesh,
    )
    if args.start_model:
        state, _, _ = load_whale_bigan(args.start_model, device)
        warm_start(trainer, state, args.start_model)
        del state

    train = trainer.upload_dataset(x, attrs)
    del x

    def save(path, state, epoch):
        save_whale_bigan(path, state, stats, meta={"epoch": epoch, "d": args.d}, kind="bigan-esrf")

    fit_gan_epochs(trainer, train, os.path.join(args.output_path or ".", "esrf-bigan.tar"), args,
                   lambda path: load_whale_bigan(path, device), save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
