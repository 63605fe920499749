"""Best-mixture counterfactual figure (port of ``cf_automatic_mix.py``): the
first test image of ``--original-digit``, the best counterfactual of the
mixture-sweep explainer toward ``--target-digit``, their thresholded
difference and the classifier's probabilities on that counterfactual.

    python -m imagecfgen_torch.cli.cf_automatic_mix --data-dir D --model-dir M \
        [--model vae|bigan] [--original-digit 3] [--target-digit 8] [--sample-points 200] \
        [--metric mixture|mse|ssim] [--output cf-automatic-mix.png] [--device cuda|cpu]

``cf.explain.DeepCounterfactualExplainer`` on the VAE (``mnist-vae.tar``,
abducting with the encoder's mean; the default) or the BiGAN
(``mnist-bigan.tar``): the image is encoded once (``fused_encoder`` at
(1, 28, 28, 5) on the card, on the chosen model's trunk), the mixtures
decoded in one batch. Four panels in one RGB PNG: the original, the best
counterfactual, the difference ``(cf - x) / 2`` with values beyond ±0.1
set to ±1, and the ten class probabilities as bars; the CLI prints the
metric.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--model", type=str, default="vae", choices=["vae", "bigan"])
parser.add_argument("--original-digit", "--original", type=int, default=3)
parser.add_argument("--target-digit", "--target", type=int, default=8)
parser.add_argument("--sample-points", type=int, default=200)
parser.add_argument("--metric", type=str, default="ssim", choices=["mixture", "mse", "ssim"])
parser.add_argument("--output", type=str, default="cf-automatic-mix.png")
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        bar_panel,
        bigan_from_state,
        has_test_split,
        image_panel,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
        load_vae,
        rows_on,
        save_panels_png,
        scale_attrs,
    )
    from ..cf.explain import DeepCounterfactualExplainer
    from ..models.classifier import mnist_classifier_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    digits = np.asarray(attrs["digit"]).argmax(axis=1)
    clf = load_classifier(os.path.join(args.model_dir, "mnist_clf.tar"), mnist_classifier_config(), device)
    if args.model == "bigan":
        from ..models.bigan import mnist_bigan_config

        state, _, _ = load_bigan(os.path.join(args.model_dir, "mnist-bigan.tar"), device)
        model = bigan_from_state(state, mnist_bigan_config(), device).eval()
        enc, dec = model.encoder, model.generator
    else:
        from ..models.vae import mnist_vae_config

        vae, _, _ = load_vae(os.path.join(args.model_dir, "mnist-vae.tar"), mnist_vae_config(), device)
        enc, dec = (lambda xx, aa: vae.encoder(xx, aa)[0]), vae.decoder
    explainer = DeepCounterfactualExplainer(enc, dec, clf, "digit")

    original = args.original_digit
    i = int(np.nonzero(digits == original)[0][0])
    xb, ab = rows_on(x, scale_attrs(scaler, attrs), slice(i, i + 1), device)
    samples, mval = explainer.explain(xb, ab, target_class=args.target_digit,
                                      sample_points=args.sample_points, metric=args.metric)
    with torch.no_grad():
        probs = torch.softmax(clf(samples[:1]), dim=1)[0].cpu().numpy()
    best, orig = samples[0].reshape(28, 28).cpu().numpy(), xb.reshape(28, 28).cpu().numpy()
    diff = (best - orig) / 2
    diff = np.where(diff < -0.1, -1.0, np.where(diff > 0.1, 1.0, diff))

    save_panels_png(args.output, [image_panel(orig), image_panel(best), image_panel(diff), bar_panel(probs)],
                    title=f"Original ({original}), CF ({args.target_digit}) metric={float(mval[0]):.4f}, "
                          "Difference, softmax probabilities")
    print(f"  best {args.metric} = {float(mval[0]):.4f}; p(target) = {probs[args.target_digit]:.4f}")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
