"""Both counterfactual explainers on one test image, and the explanation
strip (port of ``mnist_cf_explain.py``).

    python -m imagecfgen_torch.cli.mnist_cf_explain --data-dir D --model-dir M \
        [--image-index 0] [--target-class 3] [--steps 30] [--output O.png] \
        [--device cuda|cpu]

Runs the mixture-sweep explainer (``--sample-points``) and the hinge-loss
explainer (``--steps`` Adam steps, digit optimised, slant and intensity
held) on row ``--image-index`` of the test split (of the train split when
there is none) toward ``--target-class``; writes a PNG of x, up to four
sweep counterfactuals and the hinge counterfactual, and prints the best
mixture weight.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-scm", type=str, default=None,
                    help="BiGAN checkpoint file (overrides --model-dir layout)")
parser.add_argument("--classifier", type=str, default=None,
                    help="classifier checkpoint file (overrides --model-dir layout)")
parser.add_argument("--image-index", type=int, default=0)
parser.add_argument("--target-class", type=int, default=3)
parser.add_argument("--sample-points", type=int, default=50)
parser.add_argument("--steps", type=int, default=30)
parser.add_argument("--output", type=str, default="mnist-cf-explain.png")
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
        explainer_models,
        has_test_split,
        load_mnist_training_data,
        rows_on,
        save_grid_png,
        scale_attrs,
    )
    from ..cf.explain import DeepCounterfactualExplainer, HingeLossCFExplainer

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    E, G, clf = explainer_models(artifact_path(args.image_scm, args.model_dir, "mnist-bigan.tar"),
                                 artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"), device)
    i = args.image_index
    xb, ab = rows_on(x, scale_attrs(scaler, attrs), slice(i, i + 1), device)

    deep = DeepCounterfactualExplainer(E, G, clf, target_feature="digit")
    samples, mval = deep.explain(xb, ab, target_class=args.target_class, sample_points=args.sample_points)
    hinge = HingeLossCFExplainer(E, G, clf, target_feature="digit", latent_dim=512,
                                 categorical_features=("digit",), features_to_ignore=("slant", "intensity"))
    x_hinge = hinge.explain(xb, ab, target_class=args.target_class, steps=args.steps,
                            rng=torch.Generator().manual_seed(args.seed))

    n_show = min(4, len(samples))
    rows = [np.repeat(xb.cpu().numpy().reshape(1, 28, 28), n_show, axis=0),
            samples[:n_show].cpu().numpy().reshape(-1, 28, 28),
            np.repeat(x_hinge.cpu().numpy().reshape(1, 28, 28), n_show, axis=0)]
    save_grid_png(args.output, rows, ["x", "mixture-sweep CFs", "hinge-loss CF"],
                  title=f"CF explanations -> {args.target_class}")
    print(f"best mixture weight: {float(mval[0]) if len(mval) else float('nan'):.3f}")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
