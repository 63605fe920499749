"""Subject-identity preservation under digit counterfactuals: per-subject
ratio matrices (port of ``audiomnist_cf_eval.py``).

    python -m imagecfgen_torch.cli.audiomnist_cf_eval --model-dir M [--out-dir O] \
        [--bigan audio-mnist-bigan.tar] [--bigan-ft F] [--vae F] [--device cuda|cpu]

For each subject and target digit d, the subject's validation clips of
another digit become digit-d counterfactuals (BiGAN, the fine-tuned BiGAN,
the VAE, and random-latent baselines); each clip's ratio is its mean
squared distance to the subject's own digit-d clips over that to every other
subject's digit-d clips (below 1: the counterfactual stays on the subject's
manifold). Writes ``{bigan,bigan_ft,vae}_cf_metric_mat.npy`` and
``{bigan,vae}_int_metric_mat.npy`` (object arrays, subjects x digits of
per-clip ratios), as the JAX script does.

``--bigan-ft`` takes a BiGAN file of either package, ``--vae`` the audio VAE
file that the JAX package's ``train_audio_mnist_vae`` wrote. The JAX script
pads every batch to one shape for its compiler; here the clips to be
counterfactualled for a digit go through the models in chunks of ``CHUNK``
rows (the largest per-(subject, digit) count, rounded up to a multiple of 8
and capped at 128: 16 on the synthetic stand-in), the last chunk as long as
it is. Each clip's ratio does not depend on its chunk: the ``bigan`` and
``bigan_ft`` matrices are the JAX script's; the ``*_int`` ones draw noise.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="audio-mnist-bigan.tar")
parser.add_argument("--bigan-ft", type=str, default=None)
parser.add_argument("--vae", type=str, default=None)
parser.add_argument("--out-dir", type=str, default="")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

NAME_MAP = {"bigan": "bigan_cf_metric_mat.npy", "bigan_ft": "bigan_ft_cf_metric_mat.npy",
            "vae": "vae_cf_metric_mat.npy", "bigan_int": "bigan_int_metric_mat.npy",
            "vae_int": "vae_int_metric_mat.npy"}


def counterfactual_models(args, device):
    """``({name: BiGAN}, the VAE or None, statistics)``: the BiGAN of
    ``--bigan`` (its statistics normalise the data), ``--bigan-ft``'s and
    ``--vae``'s, in eval mode."""
    from .audio_common import load_audio_bigan_model, load_audio_vae

    model, stats, _ = load_audio_bigan_model(os.path.join(args.model_dir, args.bigan), device)
    models = {"bigan": model}
    if args.bigan_ft:
        models["bigan_ft"] = load_audio_bigan_model(os.path.join(args.model_dir, args.bigan_ft), device)[0]
    vae = load_audio_vae(os.path.join(args.model_dir, args.vae), device) if args.vae else None
    return models, vae, stats


def digit_counterfactuals(models, vae, x, attrs, rows, d: int, chunk: int, rng, vae_int: bool = True):
    """Every model's digit-``d`` counterfactuals of ``x[rows]`` and the
    random-latent baselines (``vae_int`` only when asked), ``{name:
    (len(rows), H*W)}``, computed ``chunk`` rows at a time."""
    import torch

    out = {}
    for i in range(0, len(rows), chunk):
        sel = torch.from_numpy(rows[i : i + chunk]).to(x.device)
        xb, ab = x[sel], {k: v[sel] for k, v in attrs.items()}
        cf_a = dict(ab, digit=torch.zeros_like(ab["digit"]).index_fill_(1, torch.tensor([d], device=x.device), 1.0))
        parts = {m: bg.generator(bg.encoder(xb, ab), cf_a) for m, bg in models.items()}
        g = models["bigan"].generator
        parts["bigan_int"] = g(torch.randn((len(sel), 1, 1, g.cfg.latent_dim), generator=rng).to(x.device), cf_a)
        if vae is not None:
            mean, _ = vae.encoder(xb, ab)
            parts["vae"] = vae.decoder(mean, cf_a)
            if vae_int:
                parts["vae_int"] = vae.decoder(torch.randn(mean.shape, generator=rng).to(x.device), cf_a)
        for m, v in parts.items():
            out.setdefault(m, []).append(v.reshape(len(sel), -1))
    return {m: torch.cat(v) for m, v in out.items()}


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_dataset, validation_images

    data = load_audio_dataset(args.zip_path)
    models, vae, stats = counterfactual_models(args, device)
    x_all, attrs_np, idx = validation_images(data, stats, device)
    attrs = {k: torch.from_numpy(v).to(device) for k, v in attrs_np.items()}
    subjects = data.raw["subject"][idx]
    digits = attrs_np["digit"].argmax(axis=1)
    n_subj = int(subjects.max())
    max_nd = max(int(((subjects == s) & (digits != d)).sum()) for s in range(1, n_subj + 1) for d in range(10))
    chunk = min(128, max(8, -(-max_nd // 8) * 8))

    names = list(models) + (["vae"] if vae is not None else []) + ["bigan_int"] + (
        ["vae_int"] if vae is not None else [])
    subj_list = [s for s in range(1, n_subj + 1) if (subjects == s).any()]
    cells = {}  # (model, subject, digit) -> per-clip ratios
    rng = torch.Generator().manual_seed(args.seed)  # the baselines' latents, drawn on the host
    x_flat = x_all.reshape(len(x_all), -1)
    for d in range(10):
        (pool_rows,) = np.nonzero(digits == d)
        pool = x_flat[torch.from_numpy(pool_rows).to(device)]
        pool_subj = subjects[pool_rows]
        (rows,) = np.nonzero(digits != d)
        with torch.no_grad():
            cfs = digit_counterfactuals(models, vae, x_all, attrs, rows, d, chunk, rng)
            # squared distances of every counterfactual to every digit-d clip, differences summed
            d2 = {m: torch.cdist(v, pool, compute_mode="donot_use_mm_for_euclid_dist") ** 2
                  for m, v in cfs.items()}
        at = {s: np.nonzero(subjects[rows] == s)[0] for s in subj_list}
        for subject in subj_list:
            n = len(at[subject])
            same = torch.from_numpy((pool_subj == subject).astype(np.float32)).to(device)
            other = 1.0 - same
            if not n or not same.any() or not other.any():
                for m in names:
                    cells[(m, subject, d)] = np.full(n or 1, np.nan)
                continue
            sel = torch.from_numpy(at[subject]).to(device)
            for m in names:
                dm = d2[m][sel]
                same_err = (dm * same).sum(1) / torch.clamp(same.sum(), min=1.0)
                other_err = (dm * other).sum(1) / torch.clamp(other.sum(), min=1.0)
                cells[(m, subject, d)] = (same_err / torch.clamp(other_err, min=1e-12)).cpu().numpy()
        print(f"digit {d}: bigan ratio "
              f"{np.nanmean(np.concatenate([cells[('bigan', s, d)] for s in subj_list])):.4f}", flush=True)

    out_dir = args.out_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    for m in names:
        mat = [[cells[(m, s, d)] for d in range(10)] for s in subj_list]
        arr = np.asarray([[np.asarray(cell) for cell in row] for row in mat], dtype=object)
        np.save(os.path.join(out_dir, NAME_MAP[m]), arr, allow_pickle=True)
        flat = np.concatenate([np.concatenate(r) for r in mat])
        print(f"{m}: mean ratio {np.nanmean(flat):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
