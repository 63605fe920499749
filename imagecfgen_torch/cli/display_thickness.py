"""Thickness-sweep figure: one row of counterfactual images as
``do(thickness = v)`` sweeps a grid (port of ``display_thickness.py``).

    python -m imagecfgen_torch.cli.display_thickness --data-dir D --model-dir M \
        [--n-points 8] [--image-index 0] [--output display-thickness.png] [--device cuda|cpu]

Row ``--image-index`` of the test split (of the train split when there is
none) is repeated ``--n-points`` times and sent through the counterfactual
engine in one batch, the thickness set to ``--n-points`` values evenly
spaced over the scaler's range: the encoder trunk runs in ``fused_encoder``
at (n-points, 28, 28, 5) on the card. Writes a one-row grayscale grid PNG.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--n-points", type=int, default=8)
parser.add_argument("--image-index", type=int, default=0)
parser.add_argument("--output", type=str, default="display-thickness.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
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
    state, scaler, _ = load_bigan(os.path.join(args.model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(os.path.join(args.model_dir, "mnist-attribute-scm.tar"), device)
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), scm, scaler, device)

    p, i = args.n_points, args.image_index
    sweep = np.linspace(float(scaler.mins["thickness"]), float(scaler.maxs["thickness"]), p).astype(np.float32)
    xb = torch.from_numpy(np.repeat(x[i:i + 1], p, axis=0)).to(device)
    ab = {k: torch.from_numpy(np.repeat(np.asarray(v)[i:i + 1], p, axis=0)).to(device) for k, v in attrs.items()}
    x_cf, _ = engine.counterfactual(xb, ab, {"thickness": torch.from_numpy(sweep.reshape(-1, 1)).to(device)},
                                    torch.Generator().manual_seed(args.seed))
    save_grid_png(args.output, [x_cf.reshape(p, 28, 28).cpu().numpy()], ["do(thickness)"],
                  title="thickness sweep " + " ".join(f"{v:.1f}" for v in sweep))
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
