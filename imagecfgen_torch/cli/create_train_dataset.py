"""Synthesise the Morpho-MNIST training set with the ground-truth SCM (port
of ``create_train_dataset.py``).

    python -m imagecfgen_torch.cli.create_train_dataset --out-dir D \
        [--synthetic 8192 | --mnist-dir RAW] [--split train] [--scale 16] \
        [--workers N] [--limit N] [--seed 0] [--noise-std 0]

Writes ``mnist-x-{split}.npy`` (N, 28, 28) and ``mnist-a-{split}.npy`` (N,
13) in the reference's column layout. The digits come from raw MNIST IDX
files with ``--mnist-dir``, else from the built-in synthetic glyphs. Each
glyph takes SetThickness, SetSlant and the intensity rescale on the host
(``--workers`` processes); ``--noise-std`` then adds Gaussian pixel noise,
the hard battery mode. Touches no tensor, so it takes no ``--device``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--mnist-dir", type=str, default=None,
                    help="directory with raw MNIST IDX files (train-images-idx3-ubyte[.gz])")
parser.add_argument("--synthetic", type=int, default=8192,
                    help="number of synthetic glyphs when --mnist-dir is absent")
parser.add_argument("--out-dir", type=str, default="")
parser.add_argument("--split", type=str, default="train", choices=["train", "test"])
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--scale", type=int, default=16,
                    help="morphology upscale factor (reference uses 16)")
parser.add_argument("--workers", type=int, default=max(os.cpu_count() - 1, 1))
parser.add_argument("--limit", type=int, default=None)
parser.add_argument("--noise-std", type=float, default=0.0,
                    help="additive Gaussian pixel noise (0-255 scale) applied after synthesis: "
                         "the 'hard' battery mode that keeps classifier/CF accuracies off the "
                         "1.0 ceiling so regressions stay detectable")


def source_digits(mnist_dir, split: str, n_synthetic: int, seed: int, limit):
    """(images in [0, 1], labels): raw MNIST's ``split`` when ``mnist_dir``
    is given, else ``n_synthetic`` synthetic glyphs from ``seed``."""
    import numpy as np

    if mnist_dir:
        from ..data.mnist import load_raw_mnist

        images, labels = load_raw_mnist(mnist_dir, split)
        images = images.astype(np.float32) / 255.0
    else:
        from ..data.synthetic_digits import synthetic_digits

        images, labels = synthetic_digits(n_synthetic, seed=seed)
        images = images / 255.0
    if limit:
        images, labels = images[:limit], labels[:limit]
    return images, labels


def add_pixel_noise(x, std: float, seed: int):
    """``clip(x + N(0, std), 0, 255)`` from ``default_rng(seed)``, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.clip(x + rng.normal(0.0, std, x.shape), 0, 255).astype(np.float32)


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np

    from ..data.morphomnist_synth import synthesize_dataset

    images, labels = source_digits(args.mnist_dir, args.split, args.synthetic,
                                   args.seed + (1 if args.split == "test" else 0), args.limit)
    x, a = synthesize_dataset(images, labels, seed=args.seed, scale=args.scale,
                              workers=args.workers, progress=True)
    if args.noise_std > 0:
        x = add_pixel_noise(x, args.noise_std, args.seed + 7919)

    os.makedirs(args.out_dir or ".", exist_ok=True)
    np.save(os.path.join(args.out_dir, f"mnist-x-{args.split}.npy"), x)
    np.save(os.path.join(args.out_dir, f"mnist-a-{args.split}.npy"), a)
    print(f"wrote {len(x)} images to {args.out_dir or '.'} (split={args.split})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
