"""Generation-quality score: the classifier's accuracy on G(z, a) (port of
``mnist_generator_score.py``).

    python -m imagecfgen_torch.cli.mnist_generator_score --model-dir M \
        [--data-dir D] [--n 4096] [--device cuda|cpu]

With ``--data-dir`` the attributes are the test split's first ``--n`` rows;
without it they are drawn from the fitted attribute SCM. Prints
``generated-sample digit accuracy: …``.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="BiGAN checkpoint file (overrides --model-dir layout)")
parser.add_argument("--classifier", "-c", type=str, default=None,
                    help="classifier checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--data-dir", type=str, default=None,
                    help="score on this dir's mnist-a-test.npy attributes instead of SCM samples")
parser.add_argument("--n", type=int, default=4096)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import (
        artifact_path,
        bigan_from_state,
        load_attribute_scm,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
    )
    from ..metrics.scores import generator_score
    from ..models.bigan import mnist_bigan_config
    from ..models.classifier import mnist_classifier_config

    state, scaler, _ = load_bigan(artifact_path(args.image_model, args.model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(
        artifact_path(args.attribute_model, args.model_dir, "mnist-attribute-scm.tar"), device)
    clf = load_classifier(artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"),
                          mnist_classifier_config(), device)
    cfg = mnist_bigan_config()
    model = bigan_from_state(state, cfg, device)

    test_attrs = None
    if args.data_dir is not None:
        _, test_attrs, _ = load_mnist_training_data(args.data_dir, "test")
        test_attrs = {k: v[: args.n] for k, v in test_attrs.items()}
    # the SCM's samples and z are drawn on the host
    acc = generator_score(model.generator, clf, scm, scaler, torch.Generator().manual_seed(args.seed),
                          n=args.n, latent_dim=cfg.latent_dim, attrs=test_attrs, device=device)
    print(f"generated-sample digit accuracy: {acc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
