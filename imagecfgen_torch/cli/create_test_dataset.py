"""Synthesise the Morpho-MNIST test set (port of ``create_test_dataset.py``).

    python -m imagecfgen_torch.cli.create_test_dataset --out-dir D \
        [--synthetic 2048 | --mnist-dir RAW] [--csv DEEPSCM.csv] [--scale 16] \
        [--workers N] [--limit N] [--seed 1] [--noise-std 0]

As ``create_train_dataset`` for the test split, into ``mnist-x-test.npy``
and ``mnist-a-test.npy``. ``--csv`` takes thickness and intensity from a
DeepSCM CSV (columns ``thickness`` and ``intensity``, reference
``create_test_dataset.py:94-109``) instead of drawing them; the slant is
still drawn. Touches no tensor, so it takes no ``--device``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--mnist-dir", type=str, default=None)
parser.add_argument("--synthetic", type=int, default=2048)
parser.add_argument("--csv", "--deepscm-csv", type=str, default=None,
                    help="optional DeepSCM csv supplying thickness/intensity")
parser.add_argument("--out-dir", type=str, default="")
parser.add_argument("--seed", type=int, default=1)
parser.add_argument("--scale", type=int, default=16)
parser.add_argument("--workers", type=int, default=max(os.cpu_count() - 1, 1))
parser.add_argument("--limit", type=int, default=None)
parser.add_argument("--noise-std", type=float, default=0.0,
                    help="additive Gaussian pixel noise (0-255 scale); match "
                         "the train split's value for the hard battery mode")


def read_csv_columns(path: str, names) -> dict:
    """The named columns of a CSV with a header row, as float64 arrays
    (the ``csv`` module: the machine with the card has no pandas)."""
    import csv

    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    missing = [k for k in names if rows and k not in rows[0]]
    if not rows or missing:
        raise ValueError(f"{path}: no rows, or no column(s) {missing}")
    return {k: np.array([float(r[k]) for r in rows], np.float64) for k in names}


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np

    from .create_train_dataset import add_pixel_noise, source_digits
    from ..data.morphomnist_synth import GroundTruthSCM, synthesize_dataset

    images, labels = source_digits(args.mnist_dir, "test", args.synthetic, args.seed, args.limit)
    attrs = None
    if args.csv:
        cols = read_csv_columns(args.csv, ("thickness", "intensity"))
        n = len(images)
        attrs = {
            "thickness": cols["thickness"][:n],
            "intensity": cols["intensity"][:n],
            "slant": GroundTruthSCM(np.random.default_rng(args.seed)).sample_slant(n)[:, 0],
        }
    x, a = synthesize_dataset(images, labels, seed=args.seed, scale=args.scale,
                              workers=args.workers, attrs=attrs, progress=True)
    if args.noise_std > 0:
        x = add_pixel_noise(x, args.noise_std, args.seed + 7920)

    os.makedirs(args.out_dir or ".", exist_ok=True)
    np.save(os.path.join(args.out_dir, "mnist-x-test.npy"), x)
    np.save(os.path.join(args.out_dir, "mnist-a-test.npy"), a)
    print(f"wrote {len(x)} test images to {args.out_dir or '.'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
