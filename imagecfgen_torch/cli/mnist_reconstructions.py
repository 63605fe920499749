"""Reconstruction grids of one or more BiGAN checkpoints, fine-tuned ones
among them (port of ``mnist_reconstructions.py``).

    python -m imagecfgen_torch.cli.mnist_reconstructions --data-dir D \
        [--model-files mnist-bigan.tar mnist-bigan-finetuned-mse.tar ...] \
        [--n-images 10] [--output O.png] [--device cuda|cpu]

The first ``--n-images`` test images (train images when there is no test
split) in the first row, then ``G(E(x, c), c)`` of each model file
(``CounterfactualEngine.reconstruct``, each file's own scaler) in a row of
its own.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-files", type=str, nargs="+", default=["mnist-bigan.tar"])
parser.add_argument("--n-images", type=int, default=10)
parser.add_argument("--output", type=str, default="mnist-reconstructions.png")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        bigan_from_state,
        has_test_split,
        load_bigan,
        load_mnist_training_data,
        rows_on,
        save_grid_png,
    )
    from ..cf.engine import CounterfactualEngine
    from ..models.bigan import mnist_bigan_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n = args.n_images
    xb, ab = rows_on(x, attrs, slice(0, n), device)

    rows, labels = [x[:n].reshape(n, 28, 28)], ["x"]
    for mf in args.model_files:
        state, scaler, _ = load_bigan(mf, device)
        engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), None, scaler,
                                      device)
        rows.append(engine.reconstruct(xb, ab).cpu().numpy().reshape(n, 28, 28))
        labels.append(os.path.basename(mf).replace(".tar", ""))

    save_grid_png(args.output, rows, labels, title="Reconstructions")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
