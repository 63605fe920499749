"""CF-effectiveness score of the BiGAN: the classifier's accuracy on the
intervened digit after a counterfactual digit swap (port of
``mnist_bigan_score.py``).

    python -m imagecfgen_torch.cli.mnist_bigan_score --data-dir D --model-dir M \
        [--limit 4096] [--batch-size 512] [--mc-rounds 1] [--device cuda|cpu]

Scores the first ``--limit`` rows of the test split (of the train split when
there is none) and prints ``cf digit accuracy: …``.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("-m", "--image-model", type=str, default=None,
                    help="explicit BiGAN checkpoint path; defaults to <model-dir>/mnist-bigan.tar")
parser.add_argument("-a", "--attribute-model", type=str, default=None)
parser.add_argument("-c", "--classifier", type=str, default=None)
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--mc-rounds", type=int, default=1)
parser.add_argument("--limit", type=int, default=4096)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--held-out-shift", nargs=3, type=float, default=None,
                    metavar=("THICKNESS", "INTENSITY", "SLANT"),
                    help="compound intervention: besides the digit swap, intervene each "
                         "continuous attribute at (observed + shift)")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


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
        load_classifier,
        load_mnist_training_data,
    )
    from ..cf.engine import CounterfactualEngine
    from ..metrics.scores import cf_effectiveness_score
    from ..models.bigan import mnist_bigan_config
    from ..models.classifier import mnist_classifier_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, _ = load_mnist_training_data(args.data_dir, split)
    x, attrs = x[: args.limit], {k: v[: args.limit] for k, v in attrs.items()}

    state, scaler, _ = load_bigan(artifact_path(args.image_model, args.model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(
        artifact_path(args.attribute_model, args.model_dir, "mnist-attribute-scm.tar"), device)
    clf = load_classifier(artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"),
                          mnist_classifier_config(), device)
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), scm, scaler, device)

    shift = None
    if args.held_out_shift:
        shift = dict(zip(("thickness", "intensity", "slant"), args.held_out_shift))
    rng = torch.Generator().manual_seed(args.seed)  # the SCM draws on the host
    scores = []
    for i in range(0, len(x), args.batch_size):
        xb = torch.from_numpy(x[i : i + args.batch_size]).to(device)
        ab = {k: torch.from_numpy(v[i : i + args.batch_size]).to(device) for k, v in attrs.items()}
        scores.append(cf_effectiveness_score(engine, clf, xb, ab, rng, mc_rounds=args.mc_rounds,
                                             held_out_shift=shift))
    print(f"cf digit accuracy: {float(np.mean(scores)):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
