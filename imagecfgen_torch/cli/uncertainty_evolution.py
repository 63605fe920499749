"""Classifier uncertainty along the counterfactual mixture path (port of
``uncertainty_evolution.py``): the class probabilities and the predictive
entropy of ``G(E(x, c), c_mix)`` as the digit's one-hot moves from the
image's own class to ``--target-class``, beside the CEM pertinent-negative
and pertinent-positive panels of the image.

    python -m imagecfgen_torch.cli.uncertainty_evolution --data-dir D --model-dir M \
        [--clf-type morpho|raw] [--image-index 0] [--target-class 3] [--n-points 50] \
        [--contrastive-steps 300] [--output uncertainty-evolution.png] [--device cuda|cpu]

E encodes the one image (``fused_encoder`` at (1, 28, 28, 5) on the card);
G decodes ``--n-points`` mixtures in one batch. ``--clf-type raw`` reads
``mnist_clf_raw.tar`` instead of ``mnist_clf.tar``. The CEM panels come
from ``cf.baselines.PixelBaselineExplainers.contrastive`` with
``--contrastive-steps`` steps: the original in gray, the pixels the
pertinent negative changes by more than 0.01 in green, the pertinent
positive's pixels above 0.01 in blue. Five panels in one RGB PNG: the two
classes' probability curves (the target emphasised), the entropy curve, the
original, the pertinent negative, the pertinent positive.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="mnist-displayed-cfs")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--clf-type", type=str, default="morpho", choices=["morpho", "raw"],
                    help="morpho: mnist_clf.tar (Morpho-MNIST-trained); raw: mnist_clf_raw.tar "
                         "(plain-MNIST-trained, reference uncertainty_evolution.py:25-27)")
parser.add_argument("--image-index", type=int, default=0)
parser.add_argument("--target-class", type=int, default=3)
parser.add_argument("--n-points", type=int, default=50)
parser.add_argument("--contrastive-steps", type=int, default=300,
                    help="optimization steps for the CEM PN/PP panels")
parser.add_argument("--output", type=str, default="uncertainty-evolution.png")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        bigan_from_state,
        curve_panel,
        has_test_split,
        image_panel,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
        rows_on,
        save_panels_png,
        scale_attrs,
    )
    from ..cf.baselines import PixelBaselineExplainers
    from ..models.bigan import mnist_bigan_config
    from ..models.classifier import mnist_classifier_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    state, _, _ = load_bigan(os.path.join(args.model_dir, "mnist-bigan.tar"), device)
    model = bigan_from_state(state, mnist_bigan_config(), device).eval()
    clf = load_classifier(os.path.join(args.model_dir, "mnist_clf.tar" if args.clf_type == "morpho"
                                       else "mnist_clf_raw.tar"), mnist_classifier_config(), device)

    i, p = args.image_index, args.n_points
    xb, ab = rows_on(x, scale_attrs(scaler, attrs), slice(i, i + 1), device)
    original = int(np.asarray(attrs["digit"]).argmax(axis=1)[i])
    with torch.no_grad():
        z = model.encoder(xb, ab)
        mix = torch.linspace(0, 1, p, device=device)[:, None]
        eye = torch.eye(10, device=device)
        cf_attrs = {k: v.repeat_interleave(p, dim=0) for k, v in ab.items() if k != "digit"}
        cf_attrs["digit"] = (1 - mix) * eye[original][None] + mix * eye[args.target_class][None]
        samples = model.generator(z.repeat_interleave(p, dim=0), cf_attrs)
        probs = torch.softmax(clf(samples), dim=1).cpu().numpy()
    entropy = -(probs * np.log(np.maximum(probs, 1e-12))).sum(axis=1)

    pn, _, pp, _ = PixelBaselineExplainers(clf, steps=args.contrastive_steps).contrastive(xb)
    x0 = xb[0, :, :, 0].cpu().numpy()
    base = (x0 + 1) / 2
    pn_display = np.repeat(base[:, :, None], 3, axis=2)
    pn_display[np.abs(pn[0, :, :, 0].cpu().numpy() - x0) > 0.01] = (0.0, 1.0, 0.0)
    pp_display = np.repeat(base[:, :, None], 3, axis=2)
    pp_display[np.abs(pp[0, :, :, 0].cpu().numpy()) > 0.01] = (0.0, 0.0, 1.0)

    panels = [curve_panel(probs[:, [original, args.target_class]].T, emphasis=1, ylim=(0.0, 1.0)),
              curve_panel(entropy[None]), image_panel(base, 0.0, 1.0), image_panel(pn_display),
              image_panel(pp_display)]
    save_panels_png(args.output, panels, title=f"uncertainty evolution {original} -> {args.target_class}: "
                    "class probabilities, predictive entropy, original, pertinent negative, pertinent positive")
    print(f"  p(class {args.target_class}) {probs[0, args.target_class]:.3f} -> {probs[-1, args.target_class]:.3f}; "
          f"entropy max {entropy.max():.3f} at mixture weight {np.argmax(entropy) / max(p - 1, 1):.2f}")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
