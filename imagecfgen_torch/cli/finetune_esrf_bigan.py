"""Encoder-only reconstruction fine-tuning of the 512^2 ESRF BiGAN (port of
``finetune_esrf_bigan.py``).

    python -m imagecfgen_torch.cli.finetune_esrf_bigan [--model-file esrf-bigan.tar] [--output-path O] \
        [--steps 20] [--metric ssim|mse] [--lr 1e-5] [--batch-size 16] [--max-batches N] \
        [--no-remat] [--device cuda|cpu]

G frozen, Adam(``--lr``) on E over ``--steps`` epochs of the training
windows, normalised with the statistics of the model file (E was trained
against them), loss = (1 - SSIM or MSE) + mean(z^2), through
``cf.finetune.EncoderFinetuner`` with the E and G forwards recomputed in
the backward pass (``--remat``, on by default). E is differentiated, so its
trunk runs as its ``PlanSequential``, never through the ``fused_encoder``
kernel. Writes ``esrf-bigan-finetuned-{metric}.tar`` in ``--output-path``
with E, G and the statistics only: scoring needs no D and no optimiser
state.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--wav-dir", "--data-dir", type=str, default=None)
parser.add_argument("--label-csv", "--labels", type=str, default=None)
parser.add_argument("--synthetic-recordings", type=int, default=24,
                    help="recordings of the synthetic stand-in (must match the training run's)")
parser.add_argument("--model-file", type=str, default="esrf-bigan.tar")
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--steps", type=int, default=20, help="epochs")
parser.add_argument("--metric", type=str, default="ssim", choices=["mse", "ssim"])
parser.add_argument("--lr", type=float, default=1e-5)
parser.add_argument("--batch-size", type=int, default=16)
parser.add_argument("--max-batches", type=int, default=None)
parser.add_argument("--remat", action="store_true", default=True)
parser.add_argument("--no-remat", dest="remat", action="store_false")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import bigan_from_state
    from .whale_common import collect_esrf_spectrograms, load_esrf_dataset, load_whale_bigan, save_whale_bigan
    from ..cf.finetune import EncoderFinetuner, FinetuneConfig
    from ..models.bigan import esrf_bigan_config
    from ..utils import profiling

    data = load_esrf_dataset(args.wav_dir, args.label_csv, args.synthetic_recordings)
    state, stats, meta = load_whale_bigan(args.model_file, device)
    spects, attrs = collect_esrf_spectrograms(data, args.max_batches, device)
    x = stats.spect_to_img(spects)[..., None]
    del spects
    print(f"fine-tuning on {len(x)} 512x512 windows")

    d = meta.get("d", 64)
    model = bigan_from_state(state, esrf_bigan_config(d=d), device).eval()
    ft = EncoderFinetuner(model, FinetuneConfig(learning_rate=args.lr, batch_size=args.batch_size,
                                                metric=args.metric, remat=args.remat), device, seed=args.seed + 1,
                           mesh=mesh)
    train = ft.upload_dataset(x, attrs)
    del x
    nb = max(len(train["image"]) // args.batch_size, 1)
    for epoch in range(args.steps):
        metrics, dt = profiling.timed(ft.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: {args.metric}={metrics['rec']:.4f} "
              f"latent={metrics['latent']:.4f} ({dt:.1f}s, {nb / dt:.1f} steps/s)", flush=True)

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, f"esrf-bigan-finetuned-{args.metric}.tar")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_whale_bigan(out, {"E": model.encoder.state_dict(), "G": state["G"]}, stats,
                         meta={"d": d, "finetuned": args.metric}, kind="bigan-esrf")
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
