"""Train the 256^2 whale-call BiGAN (port of ``train_whale_bigan.py``).

    python -m imagecfgen_torch.cli.train_whale_bigan [--nocall-dir N --shotgun-dir S --upcall-dir U] \
        [--output-path O] [--steps 200] [--d 64] [--batch-size 32] [--remat] [--throughput] \
        [--init-std S] [--start-model M] [--resume] [--checkpoint-every 10] [--device cuda|cpu]

``--steps`` counts epochs. The training windows' spectrograms are computed
once on the device, normalised with their per-column statistics and kept
there; Adam(1e-4, betas 0.5 and 0.9), one D update pair a step; each step's
detached ``E(x)`` runs in the ``fused_encoder`` kernel on the card, and
``--remat`` recomputes the E, G and D forwards in the backward pass.
``--start-model`` takes E, G and D (and the statistics it saves) from a
BiGAN file of either package. ``whale-bigan.tar`` holds the trainer's whole
state (so ``--resume`` continues it bit for bit on the same device), the
statistics, ``d`` and the epoch; ``--resume`` also takes over a file that the
JAX package wrote, which carries no generator: the run draws its noise anew
from ``--seed``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--nocall-dir", type=str, default=None)
parser.add_argument("--shotgun-dir", type=str, default=None)
parser.add_argument("--upcall-dir", type=str, default=None)
parser.add_argument("--synthetic-clips", type=int, default=32,
                    help="per-class clip count of the synthetic stand-in (when no recordings are given)")
parser.add_argument("--steps", type=int, default=200, help="epochs")
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--filter-length", type=int, default=None)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--start-model", type=str, default=None)
parser.add_argument("--d", type=int, default=64)
parser.add_argument("--init-std", type=float, default=None,
                    help="conv init std override (the config's 0.001 by default, which sits at "
                         "D = 0.5 for thousands of steps; 0.01 escapes at once)")
parser.add_argument("--remat", action="store_true", default=False,
                    help="recompute the forwards in the backward pass (fewer live activations)")
parser.add_argument("--no-remat", dest="remat", action="store_false")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--throughput", action="store_true",
                    help="opt-in speed mode: one D update a step on the concatenated pairs, one D "
                         "forward in the E+G phase, Adam's first moment in bfloat16. Changes the "
                         "training semantics; the default keeps the reference's")
parser.add_argument("--resume", action="store_true",
                    help="continue from an existing whale-bigan.tar in --output-path")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import dataclasses

    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import fit_gan_epochs, warm_start
    from .train_mnist_image_scm import throughput_kw
    from .whale_common import collect_whale_arrays, load_whale_bigan, load_whale_dataset, save_whale_bigan
    from ..models import bigan
    from ..train.gan_trainer import GANTrainConfig, GANTrainer

    data = load_whale_dataset(args.nocall_dir, args.shotgun_dir, args.upcall_dir,
                              filter_length=args.filter_length, synthetic_clips=args.synthetic_clips)
    x, calls, stats = collect_whale_arrays(data, "train", device=device)
    print(f"training on {len(x)} spectrogram windows")

    cfg = bigan.whale_bigan_config(d=args.d)
    if args.init_std is not None:
        cfg = dataclasses.replace(cfg, init_std=args.init_std)
    trainer = GANTrainer(
        bigan.BiGAN(cfg, device, torch.Generator().manual_seed(args.seed)),
        GANTrainConfig(learning_rate=args.l_rate, betas=(0.5, 0.9), batch_size=args.batch_size,
                       remat=args.remat, **throughput_kw(args)),
        device, seed=args.seed, mesh=mesh,
    )
    if args.start_model:
        state, stats, _ = load_whale_bigan(args.start_model, device)
        warm_start(trainer, state, args.start_model)
        del state

    train = trainer.upload_dataset(x, {"call_type": calls})
    del x

    def save(path, state, epoch):
        save_whale_bigan(path, state, stats, meta={"epoch": epoch, "d": args.d})

    fit_gan_epochs(trainer, train, os.path.join(args.output_path or ".", "whale-bigan.tar"), args,
                   lambda path: load_whale_bigan(path, device), save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
