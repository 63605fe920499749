"""Generation quality of the AudioMNIST VAE decoder (port of
``audiomnist_vae_generator_score.py``): the attribute classifier's accuracy
on ``decoder(z, a)``, ``a`` drawn from the causal graph and ``z`` from
N(0, 1).

    python -m imagecfgen_torch.cli.audiomnist_vae_generator_score --model-dir M \
        [--attribute digit] [--n 10000] [--batch-size 256] [--mc-rounds 4] [--device cuda|cpu]

Prints ``vae generated {attribute} accuracy: ...``; needs no dataset. The
classifier's head runs through ``fused_dense`` on the card, at
``--batch-size`` rows and the remainder.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="VAE checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--digit-clf", type=str, default=None)
parser.add_argument("--gender-clf", type=str, default=None)
parser.add_argument("--accent-clf", type=str, default=None)
parser.add_argument("--zip-path", "-d", "--data", type=str, default="AudioMNIST-data.zip",
                    help="accepted for the reference's command lines (generation needs no dataset)")
parser.add_argument("--mc-rounds", "-r", type=int, default=4,
                    help="scoring passes with fresh z draws, averaged")
parser.add_argument("--attribute", type=str, default="digit")
parser.add_argument("--n", "-n", "--num-samples", type=int, default=10_000)
parser.add_argument("--batch-size", type=int, default=256)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_classifier, load_audio_scm, load_audio_vae_model, one_hots
    from .audiomnist_bigan_score import classifier_path
    from .common import artifact_path
    from ..scm.audio_mnist import CARDINALITIES

    model, _, _ = load_audio_vae_model(artifact_path(args.image_model, args.model_dir, "audio-mnist-vae.tar"),
                                       device)
    scm = load_audio_scm(artifact_path(args.attribute_model, args.model_dir, "audio-mnist-attribute-scm.tar"),
                         device)
    clf, _, _ = load_audio_classifier(classifier_path(args), CARDINALITIES[args.attribute], device)
    rng = torch.Generator().manual_seed(args.seed)  # the draws are made on the host
    correct = torch.zeros((), dtype=torch.long, device=device)
    with torch.no_grad():
        for _ in range(args.mc_rounds):
            for i in range(0, args.n, args.batch_size):
                b = min(args.batch_size, args.n - i)
                samp = scm.sample(rng, n=b, device=device)
                z = torch.randn((b, 1, 1, model.cfg.latent_dim), generator=rng).to(device)
                pred = clf(model.decoder(z, one_hots(samp))).argmax(dim=1)
                correct += (pred == samp[args.attribute].reshape(-1)).sum()
    print(f"vae generated {args.attribute} accuracy: {correct.item() / (args.n * args.mc_rounds):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
