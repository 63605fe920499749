"""Encoder-only reconstruction fine-tuning of the MNIST BiGAN (port of
``finetune_mnist_bigan.py``).

    python -m imagecfgen_torch.cli.finetune_mnist_bigan --data-dir D \
        [--model-file mnist-bigan.tar] [--steps 20] [--metric mse|ssim] \
        [--lr 1e-5] [--batch-size 128] [--device cuda|cpu]

G frozen, Adam(``--lr``) on E over ``--steps`` epochs of the training
split (attributes scaled by that split's minima and maxima), loss = (MSE or
1 - SSIM) + mean(z^2), through ``cf.finetune.EncoderFinetuner``. Writes
``mnist-bigan-finetuned-{metric}.tar`` in the working directory (the port's
format, written by ``save_bigan``: the port's readers load it, and
``mnist_reconstructions`` renders it), with the checkpoint's G, D and
optimiser states unchanged.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--steps", type=int, default=20, help="epochs")
parser.add_argument("--model-file", type=str, default="mnist-bigan.tar")
parser.add_argument("--metric", type=str, default="mse", choices=["mse", "ssim"])
parser.add_argument("--lr", type=float, default=1e-5)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import bigan_from_state, load_bigan, load_mnist_training_data, save_bigan, scale_attrs
    from ..cf.finetune import EncoderFinetuner, FinetuneConfig
    from ..models.bigan import mnist_bigan_config
    from ..utils import profiling

    x, attrs, data_scaler = load_mnist_training_data(args.data_dir, "train")
    state, scaler, _ = load_bigan(args.model_file, device)
    model = bigan_from_state(state, mnist_bigan_config(), device)
    ft = EncoderFinetuner(model, FinetuneConfig(learning_rate=args.lr, batch_size=args.batch_size,
                                                metric=args.metric), device, seed=args.seed + 1, mesh=mesh)
    data = ft.upload_dataset(x, scale_attrs(data_scaler, attrs))

    for epoch in range(args.steps):
        metrics, dt = profiling.timed(ft.fit_epoch, data)
        print(f"epoch {epoch + 1}/{args.steps}: {args.metric}={metrics['rec']:.4f} "
              f"latent={metrics['latent']:.4f} ({(len(x) // args.batch_size) / dt:.1f} steps/s)")

    state = dict(state, E=model.encoder.state_dict())
    out = f"mnist-bigan-finetuned-{args.metric}.tar"
    if mesh.is_main:
        save_bigan(out, state, scaler, meta={"finetuned": args.metric})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
