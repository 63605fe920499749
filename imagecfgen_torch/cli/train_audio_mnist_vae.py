"""Train the AudioMNIST conditional VAE (port of ``train_audio_mnist_vae.py``).

    python -m imagecfgen_torch.cli.train_audio_mnist_vae [--zip-path Z] [--output-path O] \
        [--steps 200] [--d 64] [--batch-size 128] [--kl-weight 1] [--resume] [--device cuda|cpu]

``--steps`` counts epochs. The spectrograms of the training runs are
computed once on the device and normalised as the BiGAN's are;
``train.vae_trainer.VAETrainer`` on ``audio_mnist_vae_config(d)`` (Adam with
optax's default betas, ``--num-samples-per-step`` reparameterised draws,
``--kl-weight``). The encoder's trunk needs a gradient here, so it runs as
its ``PlanSequential`` (cuDNN convs), never through the ``fused_encoder``
kernel. ``audio-mnist-vae.tar`` holds the trainer's whole state (so
``--resume`` continues it bit for bit on the same device), the statistics,
``d`` and the epoch; ``--resume`` also takes over a resumable file that the
JAX package wrote, which carries no generator: the run draws its noise anew
from ``--seed``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--steps", type=int, default=200, help="epochs")
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--num-samples-per-step", type=int, default=4)
parser.add_argument("--kl-weight", type=float, default=1.0)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--d", type=int, default=64)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--resume", action="store_true",
                    help="continue from an existing audio-mnist-vae.tar in --output-path")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .audio_common import load_audio_dataset, load_audio_vae_state, prepare_training_arrays, save_audio_vae
    from ..models.vae import ConditionalVAE, audio_mnist_vae_config
    from ..train.vae_trainer import VAETrainConfig, VAETrainer
    from ..utils import profiling

    data = load_audio_dataset(args.zip_path)
    x, attrs, stats = prepare_training_arrays(data, device=device)
    model = ConditionalVAE(audio_mnist_vae_config(d=args.d), device, torch.Generator().manual_seed(args.seed))
    trainer = VAETrainer(
        model,
        VAETrainConfig(learning_rate=args.l_rate, batch_size=args.batch_size,
                       num_samples_per_step=args.num_samples_per_step, kl_weight=args.kl_weight),
        device, seed=args.seed + 1, mesh=mesh,
    )
    out_dir = args.output_path or "."
    out = os.path.join(out_dir, "audio-mnist-vae.tar")
    os.makedirs(out_dir, exist_ok=True)
    start_epoch = 0
    if args.resume and os.path.exists(out):
        state, _, meta = load_audio_vae_state(out, device)
        if state is None:
            print(f"warning: {out} predates resumable VAE checkpoints; not resuming")
        else:
            trainer.load_state_dict(state)
            start_epoch = int(meta.get("epoch", 0))
            print(f"resumed from {out} at epoch {start_epoch} (step {trainer.step})")

    train = trainer.upload_dataset(x, attrs)
    del x
    nb = len(train["image"]) // args.batch_size
    for epoch in range(start_epoch, args.steps):
        metrics, dt = profiling.timed(trainer.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: -elbo={metrics['neg_elbo']:.2f} ({nb / dt:.1f} steps/s)")
        due = (epoch + 1) % args.checkpoint_every == 0 or (epoch + 1) == args.steps
        if due and mesh.is_main:
            save_audio_vae(out, trainer.state_dict(), stats, meta={"epoch": epoch + 1, "d": args.d})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
