"""Measured counterfactuals of the VAE baseline: do(attr) median absolute
measurement error (port of ``mnist_vae_measured_cf.py``).

    python -m imagecfgen_torch.cli.mnist_vae_measured_cf --data-dir D \
        --model-dir M [--cf-attribute thickness|intensity|slant] [--limit 256] \
        [--workers N] [--output O.png] [--device cuda|cpu]

As ``mnist_gan_measured_cf`` with the VAE's counterfactual: the attribute
SCM abducts, intervenes and predicts the attributes, then the decoder takes
the encoder's mean under the counterfactual attributes. Prints ``median abs
errors: {...}``; ``--output`` holds one target-against-measured panel for
each intervened attribute. ``--latent-dim`` is accepted and ignored, as in
the JAX script.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model-file", type=str, default=None,
                    help="VAE checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attr-model-file", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--cf-attribute", type=str, default=None,
                    choices=["thickness", "intensity", "slant"],
                    help="restrict to one intervened attribute (default: all three)")
parser.add_argument("--latent-dim", type=int, default=None,
                    help="accepted for reference CLI compatibility; the VAE latent dim is fixed "
                         "by the architecture/checkpoint")
parser.add_argument("--limit", type=int, default=256)
parser.add_argument("--workers", type=int, default=max(os.cpu_count() - 1, 1))
parser.add_argument("--output", type=str, default="mnist-vae-measured-cf.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--target-shift", type=float, default=0.0,
                    help="add a constant to the sampled thickness targets, pushing interventions "
                         "beyond the training range (held-out magnitudes: the hard battery mode)")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def graph_obs(ab):
    """The model's attribute dict -> the attribute SCM's observation."""
    import torch

    obs = {k: ab[k].reshape(-1, 1) for k in ("thickness", "intensity", "slant")}
    obs["digit"] = torch.argmax(ab["digit"], dim=1)
    return obs


def model_attrs(cf_obs, digit=None):
    """The attribute SCM's counterfactual -> the model's attribute dict
    (``digit``: keep this one-hot digit instead of the counterfactual's)."""
    import torch.nn.functional as F

    out = {k: cf_obs[k].reshape(-1) for k in ("thickness", "intensity", "slant")}
    out["digit"] = F.one_hot(cf_obs["digit"].reshape(-1).long(), 10).float() if digit is None else digit
    return out


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import artifact_path, has_test_split, load_attribute_scm, load_mnist_training_data, load_vae
    from .mnist_gan_measured_cf import ATTRIBUTES, draw_target, measure_and_plot
    from ..data.morphomnist_synth import GroundTruthSCM
    from ..models.vae import mnist_vae_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n = min(args.limit, len(x))
    xb = torch.from_numpy(x[:n]).to(device)
    ab = {k: torch.from_numpy(v[:n]).to(device) for k, v in attrs.items()}

    vae, scaler, _ = load_vae(artifact_path(args.image_model_file, args.model_dir, "mnist-vae.tar"),
                              mnist_vae_config(), device)
    scm = load_attribute_scm(
        artifact_path(args.attr_model_file, args.model_dir, "mnist-attribute-scm.tar"), device)

    gt = GroundTruthSCM(np.random.default_rng(args.seed))
    obs = graph_obs(ab)
    targets, x_cfs = {}, {}
    for i, attribute in enumerate((args.cf_attribute,) if args.cf_attribute else ATTRIBUTES):
        targets[attribute] = draw_target(gt, attribute, n, attrs["thickness"][:n], args.target_shift)
        do = {attribute: torch.from_numpy(targets[attribute]).to(device)}
        with torch.no_grad():
            cf_obs = scm.sample_cf(torch.Generator().manual_seed(args.seed + i), obs, do)
        x_cf = vae.counterfactual(xb, scaler.scale(ab), scaler.scale(model_attrs(cf_obs)))
        x_cfs[attribute] = x_cf.cpu().numpy()
    measure_and_plot(x_cfs, targets, args.workers, args.output, "Morpho-MNIST measured CF parity (VAE)")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
