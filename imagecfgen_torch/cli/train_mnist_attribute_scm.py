"""Fit the MNIST attribute SCM (flows + categorical) by MLE
(port of ``train_mnist_attribute_scm.py``).

    python -m imagecfgen_torch.cli.train_mnist_attribute_scm --data-dir D \
        [--output-path O] [--steps 200] [--device cuda|cpu]

Writes ``mnist-attribute-scm.tar`` and ``attribute-scm-hists.png``: for
thickness, intensity and slant, the data's density (gray bars) against the
fitted model's samples (white marks), one panel a row.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--steps", type=int, default=200)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--batch-size", type=int, default=10_000)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

HIST_NAMES = ("thickness", "intensity", "slant")


def histogram_panel(data, model, bins: int = 50, height: int = 48):
    """Two densities over the bins of ``data``'s range as an image in [0, 1]
    (two pixels a bin): ``data`` as bars at 0.5, ``model`` as a mark at 1."""
    import numpy as np

    edges = np.linspace(data.min(), data.max(), bins + 1)
    dens = [np.histogram(v, bins=edges, density=True)[0] for v in (data, model)]
    top = max(float(d.max()) for d in dens) or 1.0
    img = np.zeros((height, 2 * bins), np.float32)
    for j in range(bins):
        hd, hm = (int(round(d[j] / top * (height - 1))) for d in dens)
        img[height - hd:, 2 * j:2 * j + 2] = 0.5
        img[height - 1 - hm, 2 * j:2 * j + 2] = 1.0
    return img


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import save_attribute_scm, save_grid_png
    from ..data.mnist import load_mnist_arrays
    from ..scm.mnist import MNISTAttributeSCM

    _, attrs = load_mnist_arrays(args.data_dir, "train")
    scm = MNISTAttributeSCM.fit(
        attrs,
        steps=args.steps,
        batch_size=min(args.batch_size, len(attrs["thickness"])),
        rng=torch.Generator().manual_seed(args.seed),
        log_every=max(args.steps // 20, 1),
        device=device,
    )

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, "mnist-attribute-scm.tar")
    os.makedirs(out_dir, exist_ok=True)
    save_attribute_scm(out, scm)
    print(f"saved {out}")

    # sanity histograms: model samples against the observed data
    samp = scm.sample(torch.Generator().manual_seed(args.seed + 1), n=10_000, device=device)
    panels = [[histogram_panel(np.asarray(attrs[k], np.float32).ravel(), samp[k].cpu().numpy().ravel())]
              for k in HIST_NAMES]
    save_grid_png(os.path.join(out_dir, "attribute-scm-hists.png"), panels,
                  [f"{k}: data (bars) against model (marks)" for k in HIST_NAMES],
                  title="attribute SCM densities", vmin=0, vmax=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
