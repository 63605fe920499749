"""CF-effectiveness of the AudioMNIST VAE (port of ``audiomnist_vae_score.py``):
the BiGAN score's loop with the VAE, abducting with the encoder's mean.

    python -m imagecfgen_torch.cli.audiomnist_vae_score --model-dir M \
        [--zip-path Z] [--attribute digit] [--batch-size 128] [--mc-rounds 4] [--device cuda|cpu]

Over the validation runs, normalised with the statistics the VAE file
carries, each batch is encoded once (the trunk through ``fused_encoder`` on
the card); each of ``--mc-rounds`` rounds resamples the attribute to a class
other than the observed one (``resample_excluding``), draws the
counterfactual attributes from the causal graph, decodes the mean with them
and classifies (the head through ``fused_dense`` on the card). Prints
``vae {attribute} cf accuracy: ...``.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", "-d", "--data", type=str, default="AudioMNIST-data.zip")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--attribute", "--cf-attr", type=str, default="digit")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="VAE checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--digit-clf", type=str, default=None)
parser.add_argument("--gender-clf", type=str, default=None)
parser.add_argument("--accent-clf", type=str, default=None)
parser.add_argument("--mc-rounds", "-r", type=int, default=4,
                    help="CF target resamples per batch, scores averaged")
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import (
        load_audio_classifier,
        load_audio_dataset,
        load_audio_scm,
        load_audio_vae_model,
        one_hots,
        validation_images,
    )
    from .audiomnist_bigan_score import classifier_path
    from .common import artifact_path
    from ..metrics.scores import resample_excluding
    from ..scm.audio_mnist import CARDINALITIES

    data = load_audio_dataset(args.zip_path)
    path = artifact_path(args.image_model, args.model_dir, "audio-mnist-vae.tar")
    model, stats, _ = load_audio_vae_model(path, device)
    if stats is None:
        raise ValueError(f"{path} carries no spectrogram statistics")
    scm = load_audio_scm(artifact_path(args.attribute_model, args.model_dir, "audio-mnist-attribute-scm.tar"),
                         device)
    clf, _, _ = load_audio_classifier(classifier_path(args), CARDINALITIES[args.attribute], device)

    x, attrs, _ = validation_images(data, stats, device)
    rng = torch.Generator().manual_seed(args.seed)  # the SCM draws on the host
    correct = torch.zeros((), dtype=torch.long, device=device)
    total = 0
    with torch.no_grad():
        for i in range(0, len(x), args.batch_size):
            xb = x[i : i + args.batch_size]
            ab = {k: torch.from_numpy(v[i : i + args.batch_size]).to(device) for k, v in attrs.items()}
            mean, _ = model.encoder(xb, ab)
            obs = {k: v.argmax(dim=1) for k, v in ab.items()}
            for _ in range(args.mc_rounds):
                new_cls = resample_excluding(scm.graph, scm.params, scm.state, rng, args.attribute, obs)
                cf_ab = one_hots(scm.sample_cf(rng, obs, {args.attribute: new_cls}))
                pred = clf(model.decoder(mean, cf_ab)).argmax(dim=1)
                correct += (pred == new_cls).sum()
                total += len(xb)
    print(f"vae {args.attribute} cf accuracy: {correct.item() / max(total, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
