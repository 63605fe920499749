"""Encoder-only reconstruction fine-tuning of the whale-call BiGAN (port of
``finetune_whale_bigan.py``).

    python -m imagecfgen_torch.cli.finetune_whale_bigan [--model-file whale-bigan.tar] [--steps 20] \
        [--metric mse|ssim] [--lr 1e-5] [--batch-size 32] [--device cuda|cpu]

G frozen, Adam(``--lr``) on E over ``--steps`` epochs of the training
windows (normalised with their own statistics, as the JAX script does),
loss = (MSE or 1 - SSIM) + mean(z^2), through
``cf.finetune.EncoderFinetuner``. E is differentiated, so its trunk runs as
its ``PlanSequential``, never through the ``fused_encoder`` kernel. Writes
``whale-bigan-finetuned-{metric}.tar`` in the working directory: the model
file's G, D, optimiser states, step and statistics, E replaced, no
generator state (as the JAX script's carries no noise key).
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--nocall-dir", type=str, default=None)
parser.add_argument("--shotgun-dir", type=str, default=None)
parser.add_argument("--upcall-dir", type=str, default=None)
parser.add_argument("--synthetic-clips", type=int, default=32,
                    help="per-class clip count of the synthetic stand-in (when no recordings are given)")
parser.add_argument("--model-file", type=str, default="whale-bigan.tar")
parser.add_argument("--steps", type=int, default=20, help="epochs")
parser.add_argument("--metric", type=str, default="mse", choices=["mse", "ssim"])
parser.add_argument("--lr", type=float, default=1e-5)
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import bigan_from_state
    from .whale_common import collect_whale_arrays, load_whale_bigan, load_whale_dataset, save_whale_bigan
    from ..cf.finetune import EncoderFinetuner, FinetuneConfig
    from ..models.bigan import whale_bigan_config
    from ..utils import profiling

    data = load_whale_dataset(args.nocall_dir, args.shotgun_dir, args.upcall_dir,
                              synthetic_clips=args.synthetic_clips)
    x, calls, _ = collect_whale_arrays(data, "train", device=device)
    state, stats, meta = load_whale_bigan(args.model_file, device)
    model = bigan_from_state(state, whale_bigan_config(d=meta.get("d", 64)), device)
    ft = EncoderFinetuner(model, FinetuneConfig(learning_rate=args.lr, batch_size=args.batch_size,
                                                metric=args.metric), device, seed=args.seed + 1, mesh=mesh)
    train = ft.upload_dataset(x, {"call_type": calls})
    del x
    nb = max(len(train["image"]) // args.batch_size, 1)
    for epoch in range(args.steps):
        metrics, dt = profiling.timed(ft.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: {args.metric}={metrics['rec']:.4f} "
              f"latent={metrics['latent']:.4f} ({nb / dt:.1f} steps/s)")

    out = f"whale-bigan-finetuned-{args.metric}.tar"
    if mesh.is_main:
        save_whale_bigan(out, dict(state, E=model.encoder.state_dict(), rng=None), stats,
                         meta={"finetuned": args.metric, "d": meta.get("d", 64)})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
