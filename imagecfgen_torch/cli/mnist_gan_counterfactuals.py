"""Counterfactual images ``do(attr + delta)`` from a trained BiGAN and
attribute SCM (port of ``mnist_gan_counterfactuals.py``).

    python -m imagecfgen_torch.cli.mnist_gan_counterfactuals --data-dir D \
        --model-dir M [--attr thickness] [--delta 2] [--n-images 8] [--device cuda|cpu]

Takes the first ``--n-images`` rows of the test split (of the train split
when there is none) and writes a grid PNG of x, G(E(x, c), c) and the
counterfactual. The model directory may come from the port's CLIs or the
JAX package's.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="", help="dir with *.tar artifacts")
parser.add_argument("--n-images", type=int, default=8)
parser.add_argument("--attr", type=str, default="thickness")
parser.add_argument("--delta", type=float, default=2.0)
parser.add_argument("--output", type=str, default="mnist-gan-counterfactuals.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        bigan_from_state,
        has_test_split,
        load_attribute_scm,
        load_bigan,
        load_mnist_training_data,
        save_grid_png,
    )
    from ..cf.engine import CounterfactualEngine
    from ..models.bigan import mnist_bigan_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n = args.n_images
    xb = torch.from_numpy(x[:n]).to(device)
    ab = {k: torch.from_numpy(v[:n]).to(device) for k, v in attrs.items()}

    state, scaler, _ = load_bigan(os.path.join(args.model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(os.path.join(args.model_dir, "mnist-attribute-scm.tar"), device)
    model = bigan_from_state(state, mnist_bigan_config(), device)
    engine = CounterfactualEngine(model, scm, scaler, device)

    iv = {args.attr: ab[args.attr].reshape((-1, 1)) + args.delta}
    x_cf, _ = engine.counterfactual(xb, ab, iv, torch.Generator().manual_seed(args.seed))
    recon = engine.reconstruct(xb, ab)

    rows = [t.reshape(n, 28, 28).cpu().numpy() for t in (xb, recon, x_cf)]
    labels = ["x", "G(E(x,c),c)", f"do({args.attr}+{args.delta:g})"]
    save_grid_png(args.output, rows, labels, title=f"do({args.attr} + {args.delta:g})")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
