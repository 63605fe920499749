"""Shape check of the AudioMNIST BiGAN (port of ``test_audio_gan.py``):
builds E, G and D of ``audio_mnist_bigan_config()``, runs E(x, c),
G(E(x, c), c), G(z, c) and D(x, z, c) at batch 2, prints their shapes and
``ok``.

    python -m imagecfgen_torch.cli.test_audio_gan [--device cuda|cpu]
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from ..models import bigan
    from ..scm.audio_mnist import CARDINALITIES

    g = torch.Generator().manual_seed(0)
    model = bigan.BiGAN(bigan.audio_mnist_bigan_config(), device, g).eval()
    b, latent = 2, model.cfg.latent_dim
    x = torch.zeros((b, 128, 128, 1), device=device)
    z = torch.randn((b, 1, 1, latent), generator=g).to(device)
    rng = np.random.default_rng(0)
    attrs = {k: torch.from_numpy(np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]).to(device)
             for k, n in CARDINALITIES.items()}
    with torch.no_grad():
        ex = model.encoder(x, attrs)
        print("E(x, c):", tuple(ex.shape))
        rec = model.generator(ex, attrs)
        print("G(E(x, c), c):", tuple(rec.shape))
        gz = model.generator(z, attrs)
        print("G(z, c):", tuple(gz.shape))
        d = model.discriminator(x, z, attrs)
        print("D(x, z, c):", tuple(d.shape))
    if not (ex.shape == (b, 1, 1, latent) and gz.shape == (b, 128, 128, 1) and d.shape == (b, 1)):
        raise RuntimeError("unexpected shapes")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
