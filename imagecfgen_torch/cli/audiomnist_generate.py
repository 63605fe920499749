"""Generate spoken digits (port of ``audiomnist_generate.py``): attributes
from the causal graph, ``G(z, a)`` averaged over ``--mc-rounds`` draws of z,
back to log-spectrograms, Griffin-Lim to 8 kHz int16 wavs, and a JSON of
each sample's attributes (with the given classifiers' predictions on the
generated spectrograms).

    python -m imagecfgen_torch.cli.audiomnist_generate --model-dir M [--outdir O] \
        [--num-samples 10] [--mc-rounds 1] [--digit-clf F] [--device cuda|cpu]

Writes ``sample-{i}.wav`` and ``sample-{i}.json``.
"""
from argparse import ArgumentParser
import json
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--zip-path", "-d", "--data", type=str, default="AudioMNIST-data.zip")
parser.add_argument("--num-samples", "-n", type=int, default=10)
parser.add_argument("--mc-rounds", "-r", type=int, default=1)
parser.add_argument("--outdir", "-o", type=str, default=".")
parser.add_argument("--image-model", "-m", type=str, default=None,
                    help="BiGAN checkpoint file (overrides --model-dir layout)")
parser.add_argument("--attribute-model", "-a", type=str, default=None,
                    help="attribute-SCM checkpoint file (overrides --model-dir layout)")
parser.add_argument("--digit-clf", type=str, default=None)
parser.add_argument("--gender-clf", type=str, default=None)
parser.add_argument("--accent-clf", type=str, default=None)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def write_wav(path: str, wav) -> None:
    """A waveform, peak-normalised, as 8 kHz int16."""
    import numpy as np
    from scipy.io import wavfile

    from ..data.audio_mnist import SAMPLE_RATE

    wav = np.asarray(wav, np.float64)
    wavfile.write(path, SAMPLE_RATE, np.int16(wav / max(np.abs(wav).max(), 1e-9) * 32767))


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_bigan_model, load_audio_classifier, load_audio_dataset, load_audio_scm, one_hots
    from .common import artifact_path
    from ..data.audio_mnist import audio_from_log_spect
    from ..scm.audio_mnist import CARDINALITIES

    model, stats, _ = load_audio_bigan_model(
        artifact_path(args.image_model, args.model_dir, "audio-mnist-bigan.tar"), device)
    scm = load_audio_scm(artifact_path(args.attribute_model, args.model_dir, "audio-mnist-attribute-scm.tar"),
                         device)
    vocabs = load_audio_dataset(args.zip_path).vocabs

    n = args.num_samples
    rng = torch.Generator().manual_seed(args.seed)  # the draws are made on the host
    samp = scm.sample(rng, n=n, device=device)
    attrs = one_hots(samp)
    with torch.no_grad():
        gen = sum(model.generator(torch.randn((n, 1, 1, model.cfg.latent_dim), generator=rng).to(device), attrs)
                  for _ in range(args.mc_rounds)) / args.mc_rounds
        spect = stats.img_to_spect(gen[..., 0])
        preds = {}
        for name, path in (("digit", args.digit_clf), ("gender", args.gender_clf), ("accent", args.accent_clf)):
            if path:  # on the generated log-spectrograms, as the reference feeds them
                clf, _, _ = load_audio_classifier(path, CARDINALITIES[name], device)
                preds[name] = clf(spect[..., None]).argmax(dim=1).cpu().numpy()
    wavs = audio_from_log_spect(spect, rng=rng).cpu().numpy()

    os.makedirs(args.outdir, exist_ok=True)
    codes = {k: v.reshape(-1).cpu().numpy() for k, v in samp.items()}
    for i in range(n):
        write_wav(os.path.join(args.outdir, f"sample-{i}.wav"), wavs[i])
        record = {}
        for k in CARDINALITIES:
            code = int(codes[k][i])
            record[k] = f"bin-{code}" if k == "age" else str(vocabs[k].categories[code])
        for k, p in preds.items():
            record[f"{k}_pred"] = str(vocabs[k].categories[int(p[i])])
        with open(os.path.join(args.outdir, f"sample-{i}.json"), "w") as fp:
            json.dump(record, fp, indent=4)
        print(json.dumps(record))
    print(f"wrote {n} wav/json pairs to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
