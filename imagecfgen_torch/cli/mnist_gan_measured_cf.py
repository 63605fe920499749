"""Measured counterfactuals of the BiGAN: do(attr) with targets drawn from
the ground-truth SCM, regenerate, measure with the morphometry oracle (port
of ``mnist_gan_measured_cf.py``).

    python -m imagecfgen_torch.cli.mnist_gan_measured_cf --data-dir D \
        --model-dir M [--limit 256] [--workers N] [--output O.png] \
        [--target-shift 0] [--device cuda|cpu]

For thickness, intensity and slant in turn, intervenes on the first
``--limit`` rows of the test split (of the train split when there is none),
measures the counterfactuals' thickness, intensity and slant on the host
(the native engine, ``--workers`` threads) and prints ``median abs errors:
{...}``. ``--output`` is a PNG of three target (x) against measured (y)
panels with the line y = x.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model", type=str, default="mnist-bigan.tar")
parser.add_argument("--attribute-model", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--model-name", type=str, default="ImageCFGen",
                    help="label used in the figure title")
parser.add_argument("--limit", type=int, default=256)
parser.add_argument("--workers", type=int, default=max(os.cpu_count() - 1, 1))
parser.add_argument("--output", type=str, default="mnist-gan-measured-cf.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--target-shift", type=float, default=0.0,
                    help="add a constant to the sampled thickness targets, pushing interventions "
                         "beyond the training range (held-out magnitudes: the hard battery mode)")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

ATTRIBUTES = ("thickness", "intensity", "slant")


def draw_target(gt, attribute: str, n: int, observed_thickness, shift: float = 0.0):
    """The ``(n, 1)`` do() targets of ``attribute`` from the ground-truth
    SCM ``gt``, as the JAX scripts draw them: thickness from its prior (plus
    ``shift``), intensity given the observed thickness, slant from its
    prior."""
    if attribute == "thickness":
        return gt.sample_thickness(n) + shift
    if attribute == "intensity":
        return gt.sample_intensity(observed_thickness.reshape(-1, 1))
    return gt.sample_slant(n)


def measure_and_plot(x_cfs, targets, workers: int, output: str, title: str):
    """Measure each attribute's counterfactuals (``[-1, 1]`` NHWC arrays),
    print the median absolute errors and save the panels; returns the
    errors."""
    from .common import save_grid_png, scatter_panel
    from ..metrics.measured import images_to_255, measure_attributes, median_abs_errors

    errors, panels, labels = {}, [], []
    for attribute, x_cf in x_cfs.items():
        measured = measure_attributes(images_to_255(x_cf), workers=workers)
        target = targets[attribute]
        err = median_abs_errors({attribute: target}, measured)
        errors.update(err)
        panels.append(scatter_panel(target[:, 0], measured[:, ATTRIBUTES.index(attribute)]))
        labels.append(f"{attribute} (median |err| {err[attribute]:.3f})")
    save_grid_png(output, [panels], ["target (x) against measured (y): " + ", ".join(labels)],
                  title=title, vmin=0.0, vmax=1.0)
    print("median abs errors:", {k: round(v, 4) for k, v in errors.items()})
    return errors


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
    )
    from ..cf.engine import CounterfactualEngine
    from ..data.morphomnist_synth import GroundTruthSCM
    from ..models.bigan import mnist_bigan_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n = min(args.limit, len(x))
    xb = torch.from_numpy(x[:n]).to(device)
    ab = {k: torch.from_numpy(v[:n]).to(device) for k, v in attrs.items()}

    state, scaler, _ = load_bigan(os.path.join(args.model_dir, args.image_model), device)
    scm = load_attribute_scm(
        artifact_path(args.attribute_model, args.model_dir, "mnist-attribute-scm.tar"), device)
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), scm, scaler, device)

    gt = GroundTruthSCM(np.random.default_rng(args.seed))
    targets, x_cfs = {}, {}
    for i, attribute in enumerate(ATTRIBUTES):
        targets[attribute] = draw_target(gt, attribute, n, attrs["thickness"][:n], args.target_shift)
        iv = {attribute: torch.from_numpy(targets[attribute]).to(device)}
        x_cf, _ = engine.counterfactual(xb, ab, iv, torch.Generator().manual_seed(args.seed + i))
        x_cfs[attribute] = x_cf.cpu().numpy()
    measure_and_plot(x_cfs, targets, args.workers, args.output,
                     f"Morpho-MNIST measured CF parity ({args.model_name})")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
