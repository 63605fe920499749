"""Class-probability curves as one attribute sweeps its range (port of
``causal_graph_cf.py``): for the first ``--n-images`` test images, sweep
``do(attr = v)`` over ``--n-points`` values evenly spaced over the scaler's
range and draw the classifier's class probabilities of each regenerated
image, one panel an image.

    python -m imagecfgen_torch.cli.causal_graph_cf [cf_attribute] --data-dir D --model-dir M \
        [--attr thickness] [--n-images 4] [--n-points 10] [--graph F] [--image-scm F] \
        [--classifier F] [--output causal-graph-cf.png] [--device cuda|cpu]

The (image x sweep point) grid goes through the counterfactual engine as one
batch (``fused_encoder`` at (n-images * n-points, 28, 28, 5) on the card).
Each panel holds ten curves over the sweep, the image's own digit
emphasised; the PNG has no axes, and the CLI prints each image's digit and
the sweep's values.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--graph", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--image-scm", type=str, default=None,
                    help="BiGAN checkpoint file (overrides --model-dir layout)")
parser.add_argument("--classifier", type=str, default=None,
                    help="classifier checkpoint file (overrides --model-dir layout)")
parser.add_argument("cf_attribute", type=str, nargs="?", default=None,
                    help="positional attribute name (reference CLI); overrides --attr")
parser.add_argument("--attr", type=str, default="thickness")
parser.add_argument("--n-images", type=int, default=4)
parser.add_argument("--n-points", "-n", "--num-samples", type=int, default=10)
parser.add_argument("--output", type=str, default="causal-graph-cf.png")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    if args.cf_attribute:
        args.attr = args.cf_attribute
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        artifact_path,
        bigan_from_state,
        curve_panel,
        has_test_split,
        load_attribute_scm,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
        save_panels_png,
    )
    from ..cf.engine import CounterfactualEngine
    from ..models.bigan import mnist_bigan_config
    from ..models.classifier import mnist_classifier_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    n, p = args.n_images, args.n_points
    state, scaler, _ = load_bigan(artifact_path(args.image_scm, args.model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(artifact_path(args.graph, args.model_dir, "mnist-attribute-scm.tar"), device)
    clf = load_classifier(artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"),
                          mnist_classifier_config(), device)
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), scm, scaler, device)

    sweep = np.linspace(float(scaler.mins[args.attr]), float(scaler.maxs[args.attr]), p).astype(np.float32)
    # images tiled across the sweep points: one batched counterfactual pass
    xb = torch.from_numpy(np.repeat(x[:n], p, axis=0)).to(device)
    ab = {k: torch.from_numpy(np.repeat(np.asarray(v)[:n], p, axis=0)).to(device) for k, v in attrs.items()}
    target = torch.from_numpy(np.tile(sweep, n).reshape(-1, 1)).to(device)
    x_cf, _ = engine.counterfactual(xb, ab, {args.attr: target}, torch.Generator().manual_seed(args.seed))
    with torch.no_grad():
        probs = torch.softmax(clf(x_cf), dim=1).reshape(n, p, 10).cpu().numpy()

    digits = np.asarray(attrs["digit"][:n]).argmax(axis=1)
    panels = [curve_panel(probs[i].T, emphasis=int(digits[i]), ylim=(0.0, 1.0)) for i in range(n)]
    save_panels_png(args.output, panels, title=f"class probability over do({args.attr}) = "
                    + " ".join(f"{v:.2f}" for v in sweep))
    for i in range(n):
        print(f"  panel {i + 1}: digit {digits[i]}, p(digit) {probs[i, 0, digits[i]]:.3f} -> "
              f"{probs[i, -1, digits[i]]:.3f}")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
