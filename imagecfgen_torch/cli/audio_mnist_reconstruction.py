"""AudioMNIST reconstructions (port of ``audio_mnist_reconstruction.py``): a
PNG grid of G(z, c), x and G(E(x, c), c) as log-spectrograms for
``--n-show`` validation clips, and with ``--write-wavs`` the first of each
row through Griffin-Lim.

    python -m imagecfgen_torch.cli.audio_mnist_reconstruction --model-dir M \
        [--bigan audio-mnist-bigan.tar] [--n-show 4] [--output audio-reconstructions] \
        [--write-wavs] [--device cuda|cpu]

Writes ``reconstructions.png`` (and ``generated.wav``, ``real.wav``,
``reconstructed.wav``) into ``--output``; the grid maps the real
spectrograms' range to 0..255.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", "-d", "--data", type=str, default="AudioMNIST-data.zip")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="audio-mnist-bigan.tar")
parser.add_argument("--n-show", type=int, default=4)
parser.add_argument("--output", type=str, default="audio-reconstructions")
parser.add_argument("--write-wavs", action="store_true")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .audio_common import load_audio_bigan_model, load_audio_dataset
    from .audiomnist_generate import write_wav
    from .common import save_grid_png
    from ..data.audio_mnist import audio_from_log_spect
    from ..scm.audio_mnist import CARDINALITIES

    data = load_audio_dataset(args.zip_path)
    model, stats, _ = load_audio_bigan_model(os.path.join(args.model_dir, args.bigan), device)
    batch = next(data.stream(batch_size=args.n_show, excluded_runs=data.validation_excluded_runs,
                             seed=args.seed, device=device))
    x = stats.spect_to_img(batch["audio"])[..., None]
    attrs = {k: torch.from_numpy(batch[k]).to(device) for k in CARDINALITIES}
    with torch.no_grad():
        codes = model.encoder(x, attrs)
        recon = model.generator(codes, attrs)
        z = torch.randn(codes.shape, generator=torch.Generator().manual_seed(args.seed)).to(device)
        gener = model.generator(z, attrs)

    os.makedirs(args.output, exist_ok=True)
    real_s, rec_s, gen_s = (stats.img_to_spect(t[..., 0]) for t in (x, recon, gener))
    save_grid_png(os.path.join(args.output, "reconstructions.png"),
                  [t.cpu().numpy() for t in (gen_s, real_s, rec_s)], ["G(z, c)", "x", "G(E(x, c), c)"],
                  title="AudioMNIST reconstructions", vmin=real_s.min().item(), vmax=real_s.max().item())
    if args.write_wavs:
        rng = torch.Generator().manual_seed(args.seed)
        for name, spec in (("generated", gen_s[:1]), ("real", real_s[:1]), ("reconstructed", rec_s[:1])):
            write_wav(os.path.join(args.output, f"{name}.wav"), audio_from_log_spect(spec, rng=rng)[0].cpu())
    print(f"saved outputs to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
