"""Subject-identity preservation through the 60-way subject classifier
(port of ``audiomnist_cf_classifier_metric.py``): after a digit
counterfactual, does the classifier still name the clip's subject?

    python -m imagecfgen_torch.cli.audiomnist_cf_classifier_metric --model-dir M \
        [--subject-clf audio-mnist-subject-clf.tar] [--bigan-ft F] [--vae F] [--device cuda|cpu]

For each target digit, the validation clips of the other digits go through
each model in chunks of 256 rows (the JAX script pads the last chunk to
256; here it is as long as it is) and the classifier; prints each model's
``subject-identity accuracy after digit CF``.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="audio-mnist-bigan.tar")
parser.add_argument("--bigan-ft", type=str, default=None)
parser.add_argument("--vae", type=str, default=None)
parser.add_argument("--subject-clf", type=str, default="audio-mnist-subject-clf.tar")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

CHUNK = 256


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import os

    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_classifier, load_audio_dataset, validation_images
    from .audiomnist_cf_eval import counterfactual_models, digit_counterfactuals

    data = load_audio_dataset(args.zip_path)
    models, vae, stats = counterfactual_models(args, device)
    sclf, _, _ = load_audio_classifier(os.path.join(args.model_dir, args.subject_clf), 60, device)
    x_all, attrs_np, idx = validation_images(data, stats, device)
    attrs = {k: torch.from_numpy(v).to(device) for k, v in attrs_np.items()}
    subjects = torch.from_numpy(data.raw["subject"][idx] - 1).to(device)
    digits = attrs_np["digit"].argmax(axis=1)
    names = list(models) + (["vae"] if vae is not None else []) + ["bigan_int"]
    hits = {m: torch.zeros((), dtype=torch.long, device=device) for m in names}
    total = 0
    rng = torch.Generator().manual_seed(args.seed)  # the baseline's latents, drawn on the host
    for d in range(10):
        (rows,) = np.nonzero(digits != d)
        for i in range(0, len(rows), CHUNK):
            sel = rows[i : i + CHUNK]
            with torch.no_grad():
                cfs = digit_counterfactuals(models, vae, x_all, attrs, sel, d, CHUNK, rng, vae_int=False)
                subj = subjects[torch.from_numpy(sel).to(device)]
                for m in names:
                    pred = sclf(cfs[m].reshape(len(sel), *x_all.shape[1:])).argmax(dim=1)
                    hits[m] += (pred == subj).sum()
            total += len(sel)
        print(f"digit {d} done", flush=True)
    for m in names:
        print(f"{m}: subject-identity accuracy after digit CF = {hits[m].item() / max(total, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
