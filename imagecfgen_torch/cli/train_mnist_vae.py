"""Train the DeepSCM conditional-VAE baseline (port of ``train_mnist_vae.py``;
defaults per ``deepscm_vae/mnist.py:136-147``: Adam 1e-4, 4 MC samples a
step, kl_weight 10).

    python -m imagecfgen_torch.cli.train_mnist_vae --data-dir D \
        [--output-path O] [--steps 200] [--batch-size 64] [--device cuda|cpu]

``--steps`` counts epochs, as in the JAX script. Prints ``epoch e/N:
-elbo=… (X steps/s)`` an epoch and writes ``mnist-vae.tar`` every
``--checkpoint-every`` epochs and at the end.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--steps", type=int, default=200, help="training epochs")
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--num-samples-per-step", type=int, default=4)
parser.add_argument("--kl-weight", type=float, default=10.0)
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import load_mnist_training_data, save_vae, scale_attrs
    from ..models.vae import ConditionalVAE, mnist_vae_config
    from ..train.vae_trainer import VAETrainConfig, VAETrainer
    from ..utils import profiling

    x, attrs, scaler = load_mnist_training_data(args.data_dir, "train")
    model = ConditionalVAE(mnist_vae_config(), device, torch.Generator().manual_seed(args.seed))
    trainer = VAETrainer(
        model,
        VAETrainConfig(learning_rate=args.l_rate, batch_size=args.batch_size,
                       num_samples_per_step=args.num_samples_per_step, kl_weight=args.kl_weight),
        device, seed=args.seed + 1, mesh=mesh,
    )
    data = trainer.upload_dataset(x, scale_attrs(scaler, attrs))

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, "mnist-vae.tar")
    os.makedirs(out_dir, exist_ok=True)
    nb = len(x) // args.batch_size
    for epoch in range(args.steps):
        metrics, dt = profiling.timed(trainer.fit_epoch, data)
        print(f"epoch {epoch + 1}/{args.steps}: -elbo={metrics['neg_elbo']:.2f} ({nb / dt:.1f} steps/s)")
        due = (epoch + 1) % args.checkpoint_every == 0 or (epoch + 1) == args.steps
        if due and mesh.is_main:
            save_vae(out, trainer.state_dict(), scaler, meta={"epoch": epoch + 1})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
