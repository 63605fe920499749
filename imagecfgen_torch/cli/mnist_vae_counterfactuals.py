"""Pixel-level counterfactual fidelity against the ground-truth SCM (port of
``mnist_vae_counterfactuals.py``).

    python -m imagecfgen_torch.cli.mnist_vae_counterfactuals --data-dir D \
        --model-dir M [--attr thickness] [--delta 2] [--limit 64] [--scale 16] \
        [--workers N] [--device cuda|cpu]

Re-perturbs the first ``--limit`` source digits with the morphometry
pipeline under do(``--attr`` + ``--delta``) (the ground-truth
counterfactuals, on the host, ``--workers`` spawned processes) and prints
the pixel MAE of the VAE's and the BiGAN's counterfactuals against them, for
each model whose checkpoint is there. ``--latent-dim`` is accepted and
ignored, as in the JAX script.
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
parser.add_argument("--latent-dim", type=int, default=None,
                    help="accepted for reference CLI compatibility; the VAE latent dim is fixed "
                         "by the architecture/checkpoint")
parser.add_argument("--attr", type=str, default="thickness")
parser.add_argument("--delta", type=float, default=2.0)
parser.add_argument("--limit", type=int, default=64)
parser.add_argument("--scale", type=int, default=16)
parser.add_argument("--workers", type=int, default=max(os.cpu_count() - 1, 1))
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        artifact_path,
        bigan_from_state,
        has_test_split,
        load_attribute_scm,
        load_bigan,
        load_mnist_training_data,
        load_vae,
    )
    from .mnist_vae_measured_cf import graph_obs, model_attrs
    from ..data.morphomnist_synth import perturb_batch
    from ..metrics.measured import images_to_255

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n = min(args.limit, len(x))
    xb = torch.from_numpy(x[:n]).to(device)
    ab = {k: torch.from_numpy(v[:n]).to(device) for k, v in attrs.items()}
    x255 = images_to_255(x[:n])

    # the ground-truth counterfactuals: the observed digits re-perturbed with
    # the intervened attribute through the morphology pipeline
    targets = {k: np.asarray(attrs[k][:n], np.float64) for k in ("thickness", "intensity", "slant")}
    targets[args.attr] = targets[args.attr] + args.delta
    gt_cf = perturb_batch(x255 / 255.0, targets["thickness"], targets["intensity"], targets["slant"],
                          args.scale, args.workers)

    iv = {args.attr: torch.from_numpy(targets[args.attr].reshape(-1, 1).astype(np.float32)).to(device)}
    scm_path = artifact_path(args.attr_model_file, args.model_dir, "mnist-attribute-scm.tar")
    results = {}

    bigan_path = os.path.join(args.model_dir, "mnist-bigan.tar")
    if os.path.exists(bigan_path):
        from ..cf.engine import CounterfactualEngine
        from ..models.bigan import mnist_bigan_config

        state, scaler, _ = load_bigan(bigan_path, device)
        engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device),
                                      load_attribute_scm(scm_path, device), scaler, device)
        x_cf, _ = engine.counterfactual(xb, ab, iv, torch.Generator().manual_seed(args.seed))
        results["bigan"] = float(np.abs(images_to_255(x_cf.cpu().numpy()) - gt_cf).mean())

    vae_path = artifact_path(args.image_model_file, args.model_dir, "mnist-vae.tar")
    if os.path.exists(vae_path):
        from ..models.vae import mnist_vae_config

        vae, scaler, _ = load_vae(vae_path, mnist_vae_config(), device)
        scm = load_attribute_scm(scm_path, device)
        with torch.no_grad():
            cf_obs = scm.sample_cf(torch.Generator().manual_seed(args.seed), graph_obs(ab), iv)
        x_cf = vae.counterfactual(xb, scaler.scale(ab), scaler.scale(model_attrs(cf_obs, ab["digit"])))
        results["vae"] = float(np.abs(images_to_255(x_cf.cpu().numpy()) - gt_cf).mean())

    for name, mae in results.items():
        print(f"{name}: pixel MAE vs ground-truth do({args.attr}+{args.delta:g}) = {mae:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
