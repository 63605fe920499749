"""CF-effectiveness score of the VAE baseline: abduct z as the encoder's
mean, intervene on the digit, decode, classify (port of
``mnist_vae_score.py``).

    python -m imagecfgen_torch.cli.mnist_vae_score --data-dir D --model-dir M \
        [--limit 4096] [--batch-size 512] [--held-out-shift T I S] [--device cuda|cpu]

Scores the first ``--limit`` rows of the test split (of the train split when
there is none): each row's digit is resampled from the attribute SCM with
its observed class excluded, and the classifier's accuracy on the new class
is printed as ``vae cf digit accuracy: …``.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="VAE checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--classifier", "-c", type=str, default=None,
                    help="classifier checkpoint file (overrides --model-dir layout)")
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--limit", type=int, default=4096)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--held-out-shift", nargs=3, type=float, default=None,
                    metavar=("THICKNESS", "INTENSITY", "SLANT"),
                    help="compound intervention: besides the digit swap, shift each continuous "
                         "attribute of the CF conditioning beyond the training range")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        artifact_path,
        has_test_split,
        load_attribute_scm,
        load_classifier,
        load_mnist_training_data,
        load_vae,
    )
    from ..metrics.scores import resample_excluding
    from ..models.classifier import mnist_classifier_config
    from ..models.vae import mnist_vae_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    x, attrs = x[: args.limit], {k: v[: args.limit] for k, v in attrs.items()}

    vae, scaler, _ = load_vae(artifact_path(args.image_model, args.model_dir, "mnist-vae.tar"),
                              mnist_vae_config(), device)
    scm = load_attribute_scm(
        artifact_path(args.attribute_model, args.model_dir, "mnist-attribute-scm.tar"), device)
    clf = load_classifier(artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"),
                          mnist_classifier_config(), device)

    rng = torch.Generator().manual_seed(args.seed)  # the SCM draws on the host
    correct, total = 0, 0
    for i in range(0, len(x), args.batch_size):
        xb = torch.from_numpy(x[i : i + args.batch_size]).to(device)
        ab = {k: torch.from_numpy(v[i : i + args.batch_size]).to(device) for k, v in attrs.items()}
        with torch.no_grad():
            new_digit = resample_excluding(scm.graph, scm.params, scm.state, rng, "digit",
                                           {"digit": torch.argmax(ab["digit"], dim=1)})
            cf_ab = dict(ab, digit=F.one_hot(new_digit, 10).float())
            if args.held_out_shift:
                for name, dv in zip(("thickness", "intensity", "slant"), args.held_out_shift):
                    cf_ab[name] = cf_ab[name] + dv
            x_cf = vae.counterfactual(xb, scaler.scale(ab), scaler.scale(cf_ab))
            pred = torch.argmax(clf(x_cf), dim=-1)
        correct += int((pred == new_digit).sum())
        total += len(xb)
    print(f"vae cf digit accuracy: {correct / total:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
