"""Fit the AudioMNIST attribute causal graph by MLE (port of
``train_audio_mnist_attribute_scm.py``).

    python -m imagecfgen_torch.cli.train_audio_mnist_attribute_scm \
        [--zip-path AudioMNIST-data.zip] [--output-path O] [--steps 2000] [--device cuda|cpu]

Fits on every clip's metadata (the synthetic stand-in's without the zip) and
writes ``audio-mnist-attribute-scm.tar``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--steps", type=int, default=2000)
parser.add_argument("--batch-size", type=int, default=10_000)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_dataset, save_audio_scm
    from ..scm.audio_mnist import AudioMNISTAttributeSCM

    data = load_audio_dataset(args.zip_path)
    attrs = data.encode_attrs(np.arange(len(data.raw["run"])))
    scm = AudioMNISTAttributeSCM.fit(attrs, steps=args.steps, batch_size=args.batch_size,
                                     rng=torch.Generator().manual_seed(args.seed),
                                     log_every=max(args.steps // 20, 1), device=device)
    out_dir = args.output_path or "."
    out = os.path.join(out_dir, "audio-mnist-attribute-scm.tar")
    os.makedirs(out_dir, exist_ok=True)
    save_audio_scm(out, scm)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
