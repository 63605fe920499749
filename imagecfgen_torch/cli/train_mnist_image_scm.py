"""Train the MNIST conditional BiGAN image SCM (port of
``train_mnist_image_scm.py``).

    python -m imagecfgen_torch.cli.train_mnist_image_scm --data-dir D \
        [--output-path O] [--steps 200] [--throughput] [--resume] [--device cuda|cpu]

``--steps`` counts epochs. Under ``torchrun`` (``torchrun --nproc-per-node N
-m imagecfgen_torch.cli.train_mnist_image_scm ...``) each of N ranks takes
its share of every batch of ``--batch-size`` rows, on its own card, and rank
0 prints and writes. Writes ``mnist-bigan.tar`` every
``--checkpoint-every`` epochs and at the end: the trainer's whole state (so
``--resume`` continues it bit for bit on the same device), the attribute
scaler and the epoch. ``--resume`` also takes over a ``mnist-bigan.tar`` that
the JAX package wrote; such a file carries no generator, so the run draws
its noise anew from ``--seed``. Every ``--save-images-every`` epochs an
``epoch-N.png`` grid holds G(z, c), x and G(E(x, c), c) of ten training rows.
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
parser.add_argument("--d-updates-per-g-update", type=int, default=3)
parser.add_argument("--save-images-every", type=int, default=2)
parser.add_argument("--checkpoint-every", type=int, default=10)
parser.add_argument("--resume", action="store_true")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--throughput", action="store_true",
                    help="opt-in speed mode: one D update a step on the concatenated pairs, one "
                         "D forward in the E+G phase, Adam's first moment in bfloat16. Changes "
                         "the training semantics; the default keeps the reference's")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def throughput_kw(args):
    """``--throughput`` -> the opt-in ``GANTrainConfig`` fields."""
    if not args.throughput:
        return {}
    import torch

    return dict(fused_d_steps=True, fused_eg_d=True, mu_dtype=torch.bfloat16)


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel, load_bigan, load_mnist_training_data, save_bigan, save_grid_png, scale_attrs
    from ..models.bigan import BiGAN, mnist_bigan_config
    from ..train.gan_trainer import GANTrainConfig, GANTrainer
    from ..utils import profiling

    mesh, device = data_parallel(args.device)

    x, attrs, scaler = load_mnist_training_data(args.data_dir, "train")
    cfg = mnist_bigan_config()
    trainer = GANTrainer(
        BiGAN(cfg, device, torch.Generator().manual_seed(args.seed)),
        GANTrainConfig(learning_rate=args.l_rate, batch_size=args.batch_size,
                       d_updates_per_g_update=args.d_updates_per_g_update, **throughput_kw(args)),
        device, seed=args.seed, mesh=mesh,
    )
    out_dir = args.output_path or "."
    ckpt_path = os.path.join(out_dir, "mnist-bigan.tar")
    start_epoch = 0
    if args.resume and os.path.exists(ckpt_path):
        state, _, meta = load_bigan(ckpt_path, device)
        trainer.load_state_dict(state)
        start_epoch = meta.get("epoch", 0)
        print(f"resumed from {ckpt_path} at epoch {start_epoch} (step {trainer.step})")

    data = trainer.upload_dataset(x, scale_attrs(scaler, attrs))
    n_show = 10  # the rows of the per-epoch sample grid
    x_demo = data["image"][:n_show]
    a_demo = {k: v[:n_show] for k, v in data["attrs"].items()}
    model = trainer.model
    os.makedirs(out_dir, exist_ok=True)
    for epoch in range(start_epoch, args.steps):
        metrics, dt = profiling.timed(trainer.fit_epoch, data)
        n_steps = len(x) // args.batch_size
        print(
            f"epoch {epoch + 1}/{args.steps}: "
            f"D(G(z))={metrics['D_score']:.4f} "
            f"D(E(x))={metrics['EG_score']:.4f} "
            f"({n_steps / dt:.1f} steps/s, step {trainer.step})"
        )

        if mesh.is_main and args.save_images_every and (epoch + 1) % args.save_images_every == 0:
            z = torch.randn((n_show, 1, 1, cfg.latent_dim),
                            generator=torch.Generator().manual_seed(args.seed + 10_000 + epoch))
            with torch.no_grad():
                gener = model.generator(z.to(device), a_demo)
                recon = model.generator(model.encoder(x_demo, a_demo), a_demo)
            save_grid_png(
                os.path.join(out_dir, f"epoch-{epoch + 1}.png"),
                [t.reshape(n_show, 28, 28).cpu().numpy() for t in (gener, x_demo, recon)],
                ["G(z, c)", "x", "G(E(x, c), c)"],
                title=f"Epoch {epoch + 1}",
            )

        due = (epoch + 1) % args.checkpoint_every == 0 or (epoch + 1) == args.steps
        if due and mesh.is_main:
            save_bigan(ckpt_path, trainer.state_dict(), scaler, meta={"epoch": epoch + 1})

    print(f"saved {ckpt_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
