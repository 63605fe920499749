"""Counterfactuals of several explainers side by side, for the first test
images (port of ``mnist_cf_comparisons.py``).

    python -m imagecfgen_torch.cli.mnist_cf_comparisons --data-dir D --model-dir M \
        [--clf-type morpho|raw] [--n-images 6] [--steps 30] [--output O.png] \
        [--device cuda|cpu]

For each of the first ``--n-images`` rows, a target digit other than its own
(``numpy.random.default_rng(--seed)``), then one PNG with five rows: x, the
hinge-loss counterfactual (``--steps`` Adam steps), the best mixture-sweep
counterfactual, the Wachter pixel counterfactual and the CEM pertinent
negative (both ``10 * --steps`` steps over the whole batch).
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="mnist-displayed-cfs")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--clf-type", type=str, default="morpho",
                    choices=["morpho", "raw"],
                    help="morpho: mnist_clf.tar (Morpho-MNIST-trained); raw: "
                         "mnist_clf_raw.tar (plain-MNIST-trained, reference "
                         "uncertainty_evolution.py:25-27)")
parser.add_argument("--n-images", type=int, default=6)
parser.add_argument("--steps", type=int, default=30)
parser.add_argument("--output", type=str, default="mnist-cf-comparisons.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        explainer_models,
        has_test_split,
        load_mnist_training_data,
        rows_on,
        save_grid_png,
        scale_attrs,
    )
    from ..cf.baselines import PixelBaselineExplainers
    from ..cf.explain import DeepCounterfactualExplainer, HingeLossCFExplainer

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    a_scaled = scale_attrs(scaler, attrs)
    n = args.n_images
    clf_file = "mnist_clf.tar" if args.clf_type == "morpho" else "mnist_clf_raw.tar"
    E, G, clf = explainer_models(os.path.join(args.model_dir, "mnist-bigan.tar"),
                                 os.path.join(args.model_dir, clf_file), device)
    hinge = HingeLossCFExplainer(E, G, clf, target_feature="digit", latent_dim=512,
                                 categorical_features=("digit",), features_to_ignore=("slant", "intensity"))
    deep = DeepCounterfactualExplainer(E, G, clf, "digit")

    rng = np.random.default_rng(args.seed)
    digits = attrs["digit"].argmax(axis=1)
    originals, hinge_cfs, deep_cfs, targets = [], [], [], []
    for i in range(n):
        xb, ab = rows_on(x, a_scaled, slice(i, i + 1), device)
        target = int(rng.choice([c for c in range(10) if c != digits[i]]))
        targets.append(target)
        originals.append(x[i].reshape(28, 28))
        cf = hinge.explain(xb, ab, target_class=target, steps=args.steps,
                           rng=torch.Generator().manual_seed(args.seed + i))
        hinge_cfs.append(cf.cpu().numpy().reshape(28, 28))
        samples, _ = deep.explain(xb, ab, target_class=target, sample_points=50)
        deep_cfs.append(samples[0].cpu().numpy().reshape(28, 28))

    baselines = PixelBaselineExplainers(clf, steps=args.steps * 10)
    x_all = torch.from_numpy(x[:n]).to(device)
    wachter_cfs, _ = baselines.counterfactual(x_all)
    pns, _, _, _ = baselines.contrastive(x_all)

    save_grid_png(
        args.output,
        [np.stack(originals), np.stack(hinge_cfs), np.stack(deep_cfs),
         wachter_cfs.cpu().numpy().reshape(n, 28, 28), pns.cpu().numpy().reshape(n, 28, 28)],
        ["x", "hinge CF", "mixture CF", "pixel CF", "CEM PN"],
        title="targets: " + " ".join(map(str, targets)),
    )
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
