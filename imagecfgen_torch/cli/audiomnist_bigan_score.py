"""CF-effectiveness of the AudioMNIST BiGAN (port of
``audiomnist_bigan_score.py``): intervene on an attribute through the causal
graph (resampled to a class other than the observed one), regenerate with
the BiGAN and score with that attribute's classifier.

    python -m imagecfgen_torch.cli.audiomnist_bigan_score --model-dir M \
        [--zip-path Z] [--attribute digit] [--batch-size 128] [--mc-rounds 4] [--device cuda|cpu]

Over the validation runs, each batch is encoded once (``fused_encoder`` on
the card) and regenerated ``--mc-rounds`` times; prints
``{attribute} cf accuracy: ...``.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", "-d", "--data", type=str, default="AudioMNIST-data.zip")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--attribute", "--cf-attr", type=str, default="digit")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="BiGAN checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--digit-clf", type=str, default=None)
parser.add_argument("--gender-clf", type=str, default=None)
parser.add_argument("--accent-clf", type=str, default=None)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--mc-rounds", "-r", type=int, default=4)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def classifier_path(args) -> str:
    """The attribute's classifier: its own flag, else the model directory's."""
    flag = {"digit": args.digit_clf, "gender": args.gender_clf, "accent": args.accent_clf}
    return flag.get(args.attribute) or os.path.join(args.model_dir, f"audio-mnist-{args.attribute}-clf.tar")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import (
        load_audio_bigan_model,
        load_audio_classifier,
        load_audio_dataset,
        load_audio_scm,
        one_hots,
        validation_images,
    )
    from .common import artifact_path
    from ..metrics.scores import resample_excluding
    from ..scm.audio_mnist import CARDINALITIES

    data = load_audio_dataset(args.zip_path)
    model, stats, _ = load_audio_bigan_model(
        artifact_path(args.image_model, args.model_dir, "audio-mnist-bigan.tar"), device)
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
            codes = model.encoder(xb, ab)
            obs = {k: v.argmax(dim=1) for k, v in ab.items()}
            for _ in range(args.mc_rounds):
                new_cls = resample_excluding(scm.graph, scm.params, scm.state, rng, args.attribute, obs)
                cf_ab = one_hots(scm.sample_cf(rng, obs, {args.attribute: new_cls}))
                pred = clf(model.generator(codes, cf_ab)).argmax(dim=1)
                correct += (pred == new_cls).sum()
                total += len(xb)
    print(f"{args.attribute} cf accuracy: {correct.item() / max(total, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
