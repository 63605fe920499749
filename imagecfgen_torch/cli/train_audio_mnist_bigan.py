"""Train the AudioMNIST spectrogram BiGAN (port of
``train_audio_mnist_bigan.py``).

    python -m imagecfgen_torch.cli.train_audio_mnist_bigan [--zip-path Z] [--output-path O] \
        [--steps 200] [--d 64] [--compute-dtype float32|bfloat16] [--throughput] \
        [--init-std S] [--resume] [--checkpoint-every 10] [--device cuda|cpu]

``--steps`` counts epochs. The spectrograms of the training runs are
computed once on the device, normalised with their per-column statistics
(clip at 3 sigma, / 3) and kept there; Adam(1e-4, betas 0.5 and 0.9), one D
update pair a step. ``--compute-dtype bfloat16`` runs the E, G and D
forwards in bfloat16 (parameters and Adam state stay float32).
``audio-mnist-bigan.tar`` holds the trainer's whole state (so ``--resume``
continues it bit for bit on the same device), the statistics, the
vocabularies and the epoch; ``--resume`` also takes over a file that the
JAX package wrote, which carries no generator: the run draws its noise anew
from ``--seed``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None,
                    help="AudioMNIST zip; synthetic stand-in when absent")
parser.add_argument("--steps", type=int, default=200, help="epochs")
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--d", type=int, default=64, help="channel multiplier")
parser.add_argument("--init-std", type=float, default=None,
                    help="conv init std override (the config's 0.001 by default; with no "
                         "batch norm in the audio D the game sits at D = 0.5 for many steps "
                         "before the activations grow; 0.01 escapes at once)")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--throughput", action="store_true",
                    help="opt-in speed mode: one D update a step on the concatenated pairs, one "
                         "D forward in the E+G phase, Adam's first moment in bfloat16. Changes "
                         "the training semantics; the default keeps the reference's")
parser.add_argument("--compute-dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"],
                    help="activation and matmul type of the E, G and D forwards (parameters and "
                         "optimiser state stay float32)")
parser.add_argument("--resume", action="store_true",
                    help="continue from an existing audio-mnist-bigan.tar in --output-path")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import dataclasses

    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .audio_common import load_audio_bigan, load_audio_dataset, prepare_training_arrays, save_audio_bigan
    from .common import fit_gan_epochs
    from .train_mnist_image_scm import throughput_kw
    from ..models import bigan
    from ..train.gan_trainer import GANTrainConfig, GANTrainer

    data = load_audio_dataset(args.zip_path)
    x, attrs, stats = prepare_training_arrays(data, device=device)
    print(f"training on {len(x)} spectrograms")

    cfg = bigan.audio_mnist_bigan_config(d=args.d, compute_dtype=getattr(torch, args.compute_dtype))
    if args.init_std is not None:
        cfg = dataclasses.replace(cfg, init_std=args.init_std)
    trainer = GANTrainer(
        bigan.BiGAN(cfg, device, torch.Generator().manual_seed(args.seed)),
        GANTrainConfig(learning_rate=args.l_rate, betas=(0.5, 0.9), batch_size=args.batch_size,
                       d_updates_per_g_update=1, **throughput_kw(args)),
        device, seed=args.seed, mesh=mesh,
    )
    train = trainer.upload_dataset(x, attrs)
    del x

    def save(path, state, epoch):
        save_audio_bigan(path, state, stats, data,
                         meta={"epoch": epoch, "d": args.d, "compute_dtype": args.compute_dtype})

    fit_gan_epochs(trainer, train, os.path.join(args.output_path or ".", "audio-mnist-bigan.tar"), args,
                   lambda path: load_audio_bigan(path, device), save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
