"""Train the unconditional AudioMNIST spectrogram GAN / WGAN-GP (port of
``train_audio_gan.py``).

    python -m imagecfgen_torch.cli.train_audio_gan [--zip-path Z] [--output-path O] \
        [--steps 200] [--loss-mode gan|wgan] [--generator-size 64] [--batch-size 64] \
        [--d-updates-per-g-update 1] [--discriminator-weight-decay 0] [--resume] [--device cuda|cpu]

``--steps`` counts epochs. The spectrograms of the training runs are
computed once on the device and normalised as the BiGAN's are;
``train.uncond_gan_trainer.UncondGANTrainer`` at ``d = --generator-size``.
``audio-gan-{loss-mode}.tar`` holds the trainer's whole state (so
``--resume`` continues it bit for bit on the same device) and the
statistics; ``--resume`` also takes over a file that the JAX package wrote,
which carries no generator: the run draws its noise anew from ``--seed``.
No kernel of the port runs here: neither network has a dense -> LeakyReLU
pair or an encoder trunk.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--steps", type=int, default=200, help="epochs")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--loss-mode", type=str, default="gan", choices=["gan", "wgan"])
parser.add_argument("--d-updates-per-g-update", type=int, default=1)
parser.add_argument("--discriminator-weight-decay", type=float, default=0.0)
parser.add_argument("--generator-size", type=int, default=64)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--resume", action="store_true",
                    help="continue from an existing artifact in --output-path")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .audio_common import load_audio_dataset, load_audio_gan, prepare_training_arrays, save_audio_gan
    from ..models.gan import UncondGANConfig
    from ..train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer
    from ..utils import profiling

    data = load_audio_dataset(args.zip_path)
    x, _, stats = prepare_training_arrays(data, device=device)
    trainer = UncondGANTrainer(
        UncondGANConfig(d=args.generator_size),
        UncondGANTrainConfig(learning_rate=args.l_rate, batch_size=args.batch_size,
                             d_updates_per_g_update=args.d_updates_per_g_update, loss_mode=args.loss_mode,
                             discriminator_weight_decay=args.discriminator_weight_decay),
        device, seed=args.seed, mesh=mesh,
    )
    out_dir = args.output_path or "."
    out = os.path.join(out_dir, f"audio-gan-{args.loss_mode}.tar")
    start_epoch = 0
    if args.resume and os.path.exists(out):
        state, _, meta = load_audio_gan(out, device)
        trainer.load_state_dict(state)
        start_epoch = int(meta.get("epoch", 0))
        print(f"resumed from {out} at epoch {start_epoch} (step {trainer.step})")

    train = trainer.upload_dataset(x)
    del x
    os.makedirs(out_dir, exist_ok=True)
    nb = max(len(train["image"]) // args.batch_size, 1)
    for epoch in range(start_epoch, args.steps):
        metrics, dt = profiling.timed(trainer.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: loss_G={metrics['loss_G']:.4f} loss_D={metrics['loss_D']:.4f} "
              f"({nb / dt:.1f} steps/s, step {trainer.step})")
        due = (epoch + 1) % args.checkpoint_every == 0 or (epoch + 1) == args.steps
        if due and mesh.is_main:
            save_audio_gan(out, trainer.state_dict(), stats, args.loss_mode,
                           meta={"epoch": epoch + 1, "d": args.generator_size})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
