"""Smoke run of the Morpho-MNIST VAE at full width (port of ``test_vae.py``):
an encoder sample, the decoder's output and a finite ELBO on two zero
images, then ``ok``.

    python -m imagecfgen_torch.cli.test_vae [--device cuda|cpu]
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
    from ..models.vae import ConditionalVAE, mnist_vae_config

    model = ConditionalVAE(mnist_vae_config(), device, torch.Generator().manual_seed(0)).eval()
    b = 2
    x = torch.zeros((b, 28, 28, 1), device=device)
    rng = np.random.default_rng(0)
    attrs = {
        "digit": torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]).to(device),
        "thickness": torch.zeros(b, device=device),
        "intensity": torch.zeros(b, device=device),
        "slant": torch.zeros(b, device=device),
    }
    key = torch.Generator().manual_seed(0)
    with torch.no_grad():
        zs = model.encode_sample(x, attrs, key)
        print("encoder sample:", tuple(zs.shape))
        dec = model.decoder(zs, attrs)
        print("decoder:", tuple(dec.shape))
        elbo = float(model.elbo(x, attrs, num_samples=2, rng=key))
    print("elbo:", elbo)
    if not (tuple(zs.shape) == (b, 1, 1, 512) and tuple(dec.shape) == (b, 28, 28, 1) and np.isfinite(elbo)):
        raise RuntimeError("test_vae: unexpected shapes or a non-finite ELBO")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
