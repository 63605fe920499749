"""Build the 10x10 digit-counterfactual difficulty matrix (port of
``make_mnist_cf_matrix.py``).

    python -m imagecfgen_torch.cli.make_mnist_cf_matrix --data-dir D --model-dir M \
        [--per-digit 4] [--metric mixture|mse|ssim] [--output O.pkl] [--device cuda|cpu]

For the first ``--per-digit`` test images of each source digit, the
mixture-sweep explainer runs toward every other digit; the cell holds the
smallest metric value among the samples the classifier labels as the
target, averaged over the images, NaN where none flips. Writes a pickle
``{"matrix", "counts", "metric"}``, read by ``show_cf_matrix``.

Unlike the JAX script, no cell catches an exception: an explainer that fails
ends the run (on the card, such a catch would hide a failing kernel).
"""
from argparse import ArgumentParser
import os
import pickle
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--per-digit", type=int, default=4)
parser.add_argument("--sample-points", type=int, default=50)
parser.add_argument("--output", type=str, default="mnist-cf-matrix.pkl")
parser.add_argument("--metric", type=str, default="mixture",
                    choices=["mixture", "mse", "ssim"])
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import explainer_models, has_test_split, load_mnist_training_data, rows_on, scale_attrs
    from ..cf.explain import DeepCounterfactualExplainer

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    a_scaled = scale_attrs(scaler, attrs)
    E, G, clf = explainer_models(os.path.join(args.model_dir, "mnist-bigan.tar"),
                                 os.path.join(args.model_dir, "mnist_clf.tar"), device)
    explainer = DeepCounterfactualExplainer(E, G, clf, target_feature="digit")

    digits = attrs["digit"].argmax(axis=1)
    matrix = np.full((10, 10), np.nan)
    counts = np.zeros((10, 10))
    for src in range(10):
        for k in np.nonzero(digits == src)[0][: args.per_digit]:
            xb, ab = rows_on(x, a_scaled, slice(k, k + 1), device)
            for tgt in range(10):
                if tgt == src:
                    continue
                samples, mval = explainer.explain(xb, ab, target_class=tgt,
                                                  sample_points=args.sample_points, metric=args.metric)
                with torch.no_grad():
                    hit = (torch.argmax(clf(samples), dim=1) == tgt).cpu().numpy()
                if hit.any():
                    best = float(mval.cpu().numpy()[hit].min())
                    matrix[src, tgt] = np.nansum([matrix[src, tgt], best]) if counts[src, tgt] else best
                    counts[src, tgt] += 1
    with np.errstate(invalid="ignore"):
        matrix = matrix / np.maximum(counts, 1)
        matrix[counts == 0] = np.nan
    with open(args.output, "wb") as f:
        pickle.dump({"matrix": matrix, "counts": counts, "metric": args.metric}, f)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
