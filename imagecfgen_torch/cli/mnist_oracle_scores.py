"""Oracle agreement and JS divergence of counterfactual explainers (port of
``mnist_oracle_scores.py``).

    python -m imagecfgen_torch.cli.mnist_oracle_scores --data-dir D --model-dir M \
        [--oracle-dir O] [--limit 64] [--steps 100] [--lr 0.01] [--weight 10] \
        [--train-codes] [--output O.csv] [--device cuda|cpu]

For each of the first ``--limit`` test images, a target digit other than its
own (``numpy.random.default_rng(--seed)``); counterfactuals from the BiGAN's
hinge-loss explainer (``bigan``), its mixture-sweep explainer
(``bigan_agnostic``), and the Wachter (``cf``) and CEM pertinent-negative
(``pn``) pixel baselines (``3 * --steps`` steps over the whole batch). Each
is scored by the classifier and the ten per-digit oracles
(``oracle-{d}.tar``): the label, whether the oracles' arg-max agrees, the
Jensen-Shannon divergence between the classifier's distribution and the
normalised oracle scores, and each oracle's sigmoid score. Writes the CSV
with the JAX script's columns (``csv`` module) and prints each explainer's
agreement rate.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--oracle-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="mnist-bigan.tar")
parser.add_argument("--limit", type=int, default=64)
parser.add_argument("--steps", type=int, default=100)
parser.add_argument("--lr", type=float, default=0.01)
parser.add_argument("--weight", type=float, default=10.0,
                    help="hinge-loss weight (explainer c)")
parser.add_argument("--train-codes", action="store_true",
                    help="also optimize the latent code (reference default: off)")
parser.add_argument("--output", type=str, default="mnist_oracle_scores.csv")
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def js_divergence(p, q, eps=1e-9) -> float:
    import numpy as np

    p = np.asarray(p) + eps
    q = np.asarray(q) + eps
    p, q = p / p.sum(), q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        return float((a * np.log(a / b)).sum())

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def explain_one(explainer, xb, ab, target: int, args, seed: int):
    """One counterfactual ``(1, 28, 28, 1)``: the hinge explainer's, or the
    best of the mixture sweep's 50 samples."""
    import torch

    from ..cf.explain import HingeLossCFExplainer

    if isinstance(explainer, HingeLossCFExplainer):
        return explainer.explain(xb, ab, target_class=target, steps=args.steps, lr=args.lr,
                                 train_z=args.train_codes, rng=torch.Generator().manual_seed(seed))
    samples, _ = explainer.explain(xb, ab, target_class=target, sample_points=50)
    return samples[:1]


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        explainer_models,
        has_test_split,
        load_classifier,
        load_mnist_training_data,
        rows_on,
        scale_attrs,
        write_csv,
    )
    from ..cf.baselines import PixelBaselineExplainers
    from ..cf.explain import DeepCounterfactualExplainer, HingeLossCFExplainer
    from ..models.classifier import mnist_oracle_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    a_scaled = scale_attrs(scaler, attrs)
    n = min(args.limit, len(x))
    E, G, clf = explainer_models(os.path.join(args.model_dir, args.bigan),
                                 os.path.join(args.model_dir, "mnist_clf.tar"), device)
    oracle_dir = args.oracle_dir or args.model_dir
    oracles = [load_classifier(os.path.join(oracle_dir, f"oracle-{d}.tar"), mnist_oracle_config(), device)
               for d in range(10)]

    def score(row, name, cf):
        with torch.no_grad():
            probs = torch.softmax(clf(cf), dim=1)[0].cpu().numpy()
            os_ = torch.cat([torch.sigmoid(o(cf))[0] for o in oracles]).cpu().numpy()
        row[f"{name}_label"] = int(probs.argmax())
        row[f"{name}_oracle_agree"] = int(os_.argmax() == probs.argmax())
        row[f"{name}_js"] = js_divergence(probs, os_)
        for j in range(10):
            row[f"{name}_os_{j}"] = float(os_[j])

    explainers = {
        "bigan": HingeLossCFExplainer(E, G, clf, target_feature="digit", latent_dim=512, c=args.weight,
                                      categorical_features=("digit",),
                                      features_to_ignore=("slant", "intensity")),
        "bigan_agnostic": DeepCounterfactualExplainer(E, G, clf, "digit"),
    }
    # the pixel baselines' columns (the reference's omnixai "cf" and "pn"),
    # each one batched run over the benchmark's images
    builtin = PixelBaselineExplainers(clf, steps=args.steps * 3, lr=args.lr)
    x_all = torch.from_numpy(x[:n]).to(device)
    baseline_images = {"cf": builtin.counterfactual(x_all)[0], "pn": builtin.contrastive(x_all)[0]}

    rng = np.random.default_rng(args.seed)
    digits = attrs["digit"].argmax(axis=1)
    rows = []
    for i in range(n):
        xb, ab = rows_on(x, a_scaled, slice(i, i + 1), device)
        digit = int(digits[i])
        target = int(rng.choice([c for c in range(10) if c != digit]))
        row = {"digit": digit, "target_class": target}
        for name, ex in explainers.items():
            score(row, name, explain_one(ex, xb, ab, target, args, args.seed + i))
        for name in ("cf", "pn"):
            score(row, name, baseline_images[name][i:i + 1])
        rows.append(row)

    write_csv(args.output, rows)
    for c in [c for c in rows[0] if c.endswith("oracle_agree")]:
        print(f"{c}: {np.mean([r[c] for r in rows]):.4f}")
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
