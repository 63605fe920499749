"""Generation-quality score of the VAE decoder: the classifier's accuracy on
``decoder(z, a)`` with ``a`` drawn from the attribute SCM (port of
``mnist_vae_generator_score.py``).

    python -m imagecfgen_torch.cli.mnist_vae_generator_score --model-dir M \
        [--n 10000] [--device cuda|cpu]

Prints ``vae generated-sample digit accuracy: …``. ``--data-dir`` is
accepted and ignored, as in the JAX script.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="VAE checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--classifier", "-c", type=str, default=None,
                    help="classifier checkpoint file (overrides --model-dir layout)")
parser.add_argument("--data-dir", type=str, default=None,
                    help="accepted for reference compatibility (generation draws attributes "
                         "from the SCM, not a dataset)")
parser.add_argument("--n", "-n", "--num-samples", type=int, default=10_000)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import artifact_path, load_attribute_scm, load_classifier, load_vae
    from ..metrics.scores import generator_score
    from ..models.classifier import mnist_classifier_config
    from ..models.vae import mnist_vae_config

    cfg = mnist_vae_config()
    vae, scaler, _ = load_vae(artifact_path(args.image_model, args.model_dir, "mnist-vae.tar"), cfg, device)
    scm = load_attribute_scm(
        artifact_path(args.attribute_model, args.model_dir, "mnist-attribute-scm.tar"), device)
    clf = load_classifier(artifact_path(args.classifier, args.model_dir, "mnist_clf.tar"),
                          mnist_classifier_config(), device)
    # the SCM's samples and z are drawn on the host
    acc = generator_score(vae.decoder, clf, scm, scaler, torch.Generator().manual_seed(args.seed),
                          n=args.n, latent_dim=cfg.latent_dim, device=device)
    print(f"vae generated-sample digit accuracy: {acc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
