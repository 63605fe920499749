"""Counterfactual-explainer realism and sparsity: autoencoder
reconstruction errors and L1 columns (port of ``morphomnist_cf_metrics.py``).

    python -m imagecfgen_torch.cli.morphomnist_cf_metrics --data-dir D --model-dir M \
        [--ae-dir A] [--limit 64] [--steps 100] [--lr 0.01] [--weight 10] \
        [--train-codes] [--output O.csv] [--device cuda|cpu]

For each of the first ``--limit`` test images, a target digit other than its
own (``numpy.random.default_rng(--seed)``), then counterfactuals from the
BiGAN's hinge-loss and mixture-sweep explainers (``bigan``,
``bigan_agnostic``), the VAE's when ``mnist-vae.tar`` is in the model
directory (``vae``, ``vae_agnostic``: the VAE encodes to its encoder's
mean), and the Wachter (``cf``) and CEM pertinent-negative (``pn``) pixel
baselines (``3 * --steps`` steps over the whole batch). Each gets its label,
``l1`` (sum |x_cf|), ``o_rec`` and ``t_rec`` (squared error of the source
digit's and the label's autoencoder ``ae-{c}.tar``) and ``all_rec``
(squared distance between the label's and the all-digit autoencoder's
reconstructions); NaN (an empty field) where an autoencoder is missing.
Writes the CSV with the JAX script's columns (``csv`` module).

The JAX script takes the two baselines from ``omnixai`` when it imports and
falls back to its own versions on any exception; the port has no omnixai
and runs its own ``cf.baselines`` directly, with the same notice.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="mnist-bigan.tar")
parser.add_argument("--limit", type=int, default=64)
parser.add_argument("--steps", type=int, default=100)
parser.add_argument("--lr", type=float, default=0.01)
parser.add_argument("--weight", type=float, default=10.0,
                    help="hinge-loss weight (explainer c)")
parser.add_argument("--train-codes", action="store_true")
parser.add_argument("--ae-dir", type=str, default="", help="dir with ae-{c}.tar / ae-all.tar")
parser.add_argument("--output", type=str, default="morphomnist_cf_metrics.csv")
parser.add_argument("--seed", type=int, default=42)
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
        load_classifier,
        load_mnist_training_data,
        load_vae,
        rows_on,
        scale_attrs,
        write_csv,
    )
    from .mnist_oracle_scores import explain_one
    from ..cf.baselines import PixelBaselineExplainers
    from ..cf.explain import DeepCounterfactualExplainer, HingeLossCFExplainer
    from ..models.classifier import AutoEncoderConfig
    from ..models.vae import mnist_vae_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    a_scaled = scale_attrs(scaler, attrs)
    n = min(args.limit, len(x))
    E, G, clf = explainer_models(os.path.join(args.model_dir, args.bigan),
                                 os.path.join(args.model_dir, "mnist_clf.tar"), device)
    hinge_kw = dict(target_feature="digit", latent_dim=512, categorical_features=("digit",),
                    features_to_ignore=("slant", "intensity"), c=args.weight)
    explainers = {"bigan": HingeLossCFExplainer(E, G, clf, **hinge_kw),
                  "bigan_agnostic": DeepCounterfactualExplainer(E, G, clf, "digit")}
    vae_path = os.path.join(args.model_dir, "mnist-vae.tar")
    if os.path.exists(vae_path):
        vae, _, _ = load_vae(vae_path, mnist_vae_config(), device)

        def vae_mean(xx, aa):
            return vae.encoder(xx, aa)[0]

        explainers["vae"] = HingeLossCFExplainer(vae_mean, vae.decoder, clf, **hinge_kw)
        explainers["vae_agnostic"] = DeepCounterfactualExplainer(vae_mean, vae.decoder, clf, "digit")

    # the realism scorers
    ae_dir = args.ae_dir or args.model_dir
    aes = {}
    for c in list(range(10)) + ["all"]:
        p = os.path.join(ae_dir, f"ae-{c}.tar")
        if os.path.exists(p):
            aes[str(c)] = load_classifier(p, AutoEncoderConfig(), device)

    @torch.no_grad()
    def o_rec(cf, c):
        if str(c) not in aes:
            return np.nan
        return float(((cf - aes[str(c)](cf)) ** 2).sum())

    @torch.no_grad()
    def all_rec(cf, c):
        if str(c) not in aes or "all" not in aes:
            return np.nan
        return float(((aes[str(c)](cf) - aes["all"](cf)) ** 2).sum())

    print("omnixai unavailable (the port does not use it); using the built-in "
          "Wachter-CF / CEM reimplementation for the cf/pn columns")
    builtin = PixelBaselineExplainers(clf, steps=args.steps * 3, lr=args.lr)
    x_all = torch.from_numpy(x[:n]).to(device)
    baseline_images = {"cf": builtin.counterfactual(x_all)[0], "pn": builtin.contrastive(x_all)[0]}

    def columns(row, name, cf, digit):
        with torch.no_grad():
            label = int(torch.argmax(clf(cf), dim=1)[0])
        row[f"{name}_label"] = label
        row[f"l1_{name}"] = float(cf.abs().sum())
        row[f"o_rec_{name}"] = o_rec(cf, digit)
        row[f"t_rec_{name}"] = o_rec(cf, label)
        row[f"all_rec_{name}"] = all_rec(cf, label)

    rng = np.random.default_rng(args.seed)
    digits = attrs["digit"].argmax(axis=1)
    rows = []
    for i in range(n):
        xb, ab = rows_on(x, a_scaled, slice(i, i + 1), device)
        digit = int(digits[i])
        target = int(rng.choice([c for c in range(10) if c != digit]))
        row = {"digit": digit, "target_class": target, "thickness": float(attrs["thickness"][i]),
               "intensity": float(attrs["intensity"][i]), "slant": float(attrs["slant"][i])}
        for name, ex in explainers.items():
            columns(row, name, explain_one(ex, xb, ab, target, args, args.seed + i), digit)
        for name in ("cf", "pn"):
            columns(row, name, baseline_images[name][i:i + 1], digit)
        rows.append(row)
        if (i + 1) % 16 == 0:
            print(f"{i + 1}/{n}")

    write_csv(args.output, rows)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
