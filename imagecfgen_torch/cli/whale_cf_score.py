"""Counterfactual effectiveness on whale calls (port of ``whale_cf_score.py``):
flip each validation window's call type to one of the other two, uniformly,
regenerate it (the BiGAN, a fine-tuned BiGAN, the VAE) and score the result
with the NARW classifier.

    python -m imagecfgen_torch.cli.whale_cf_score --model-dir M [--bigan-ft F] [--vae V] \
        [--nocall-dir N --shotgun-dir S --upcall-dir U] [--batch-size 32] [--device cuda|cpu]

Prints ``{model}: call-type cf accuracy = ...`` for each model. The
encoders run under ``torch.no_grad()``: on the card each batch's ``E(x)``
(and the VAE's mean) is one ``fused_encoder`` launch, and each classification
one ``fused_dense`` launch. The new classes come from ``draw_new_classes``,
a ``torch.Generator`` of ``--seed`` on the host.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--nocall-dir", type=str, default=None)
parser.add_argument("--shotgun-dir", type=str, default=None)
parser.add_argument("--upcall-dir", type=str, default=None)
parser.add_argument("--synthetic-clips", type=int, default=32,
                    help="per-class clip count of the synthetic stand-in (when no recordings are given)")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="whale-bigan.tar")
parser.add_argument("--bigan-ft", type=str, default=None)
parser.add_argument("--vae", type=str, default=None)
parser.add_argument("--clf", type=str, default="whale-clf.tar")
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def draw_new_classes(rng, current):
    """For each current class (an integer tensor on the host), one of the
    other two, uniformly: the law of the reference's rejection loop
    (``whale_cf_score.py:62-65``)."""
    import torch

    return (current + 1 + torch.randint(0, 2, current.shape, generator=rng)) % 3


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import bigan_from_state
    from .whale_common import collect_whale_arrays, load_whale_bigan, load_whale_classifier
    from .whale_common import load_whale_dataset, load_whale_vae
    from ..models.bigan import whale_bigan_config

    data = load_whale_dataset(args.nocall_dir, args.shotgun_dir, args.upcall_dir,
                              synthetic_clips=args.synthetic_clips)
    state, _, meta = load_whale_bigan(os.path.join(args.model_dir, args.bigan), device)
    x, calls, _ = collect_whale_arrays(data, "validation", device=device)
    clf, _ = load_whale_classifier(os.path.join(args.model_dir, args.clf), device)
    cfg = whale_bigan_config(d=meta.get("d", 64))
    models = {"bigan": bigan_from_state(state, cfg, device).eval()}
    if args.bigan_ft:
        ft, _, _ = load_whale_bigan(os.path.join(args.model_dir, args.bigan_ft), device)
        models["bigan_ft"] = bigan_from_state(ft, cfg, device).eval()
    vae = load_whale_vae(os.path.join(args.model_dir, args.vae), device)[0] if args.vae else None

    rng = torch.Generator().manual_seed(args.seed)
    hits = {m: [0, 0] for m in [*models, *(["vae"] if vae is not None else [])]}
    with torch.no_grad():
        for i in range(0, len(x), args.batch_size):
            xb = x[i:i + args.batch_size]
            cb = torch.from_numpy(calls[i:i + args.batch_size]).to(device)
            new_cls = draw_new_classes(rng, cb.argmax(dim=1).cpu()).to(device)
            cf_a, ab = {"call_type": F.one_hot(new_cls, 3).float()}, {"call_type": cb}
            codes = {m: (bg.encoder(xb, ab), bg.generator) for m, bg in models.items()}
            if vae is not None:
                codes["vae"] = (vae.encoder(xb, ab)[0], vae.decoder)
            for m, (z, decode) in codes.items():
                pred = clf(decode(z, cf_a)).argmax(dim=1)
                hits[m][0] += int((pred == new_cls).sum())
                hits[m][1] += len(xb)
    for m, (c, t) in hits.items():
        print(f"{m}: call-type cf accuracy = {c / max(t, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
