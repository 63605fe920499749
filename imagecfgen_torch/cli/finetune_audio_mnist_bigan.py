"""Encoder-only reconstruction fine-tuning of the AudioMNIST BiGAN (port of
``finetune_audio_mnist_bigan.py``).

    python -m imagecfgen_torch.cli.finetune_audio_mnist_bigan [--zip-path Z] \
        [--model-file audio-mnist-bigan.tar] [--steps 20] [--metric mse|ssim] \
        [--lr 1e-5] [--batch-size 128] [--device cuda|cpu]

G frozen, Adam(``--lr``) on E over ``--steps`` epochs of the training runs'
spectrograms (normalised with their own statistics, as the JAX script
does), loss = (MSE or 1 - SSIM) + mean(z^2), through
``cf.finetune.EncoderFinetuner`` with the E and G forwards recomputed in
the backward pass (``torch.utils.checkpoint``) at 128^2. E is
differentiated, so its trunk runs as its ``PlanSequential``, never through
the ``fused_encoder`` kernel. Writes
``audio-mnist-bigan-finetuned-{metric}.tar`` in the working directory (the
port's format: the checkpoint's G, D, optimiser states and statistics
unchanged, E replaced), at the ``d`` of the model file's meta.
"""
from argparse import ArgumentParser
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", "-d", "--data", type=str, default=None)
parser.add_argument("--model-file", type=str, default="audio-mnist-bigan.tar")
parser.add_argument("--steps", type=int, default=20, help="epochs")
parser.add_argument("--metric", type=str, default="mse", choices=["mse", "ssim"])
parser.add_argument("--lr", type=float, default=1e-5)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .audio_common import load_audio_bigan, load_audio_dataset, prepare_training_arrays, save_audio_bigan
    from .common import bigan_from_state
    from ..cf.finetune import EncoderFinetuner, FinetuneConfig
    from ..models.bigan import audio_mnist_bigan_config
    from ..utils import profiling

    data = load_audio_dataset(args.zip_path)
    x, attrs, _ = prepare_training_arrays(data, device=device)
    state, stats, meta = load_audio_bigan(args.model_file, device)
    d = meta.get("d", 64)
    model = bigan_from_state(state, audio_mnist_bigan_config(d=d), device)
    ft = EncoderFinetuner(model, FinetuneConfig(learning_rate=args.lr, batch_size=args.batch_size,
                                                metric=args.metric, remat=True), device, seed=args.seed + 1,
                           mesh=mesh)
    train = ft.upload_dataset(x, attrs)
    del x
    nb = len(train["image"]) // args.batch_size
    for epoch in range(args.steps):
        metrics, dt = profiling.timed(ft.fit_epoch, train)
        print(f"epoch {epoch + 1}/{args.steps}: {args.metric}={metrics['rec']:.4f} "
              f"latent={metrics['latent']:.4f} ({nb / dt:.1f} steps/s)")

    state = dict(state, E=model.encoder.state_dict())
    out = f"audio-mnist-bigan-finetuned-{args.metric}.tar"
    if mesh.is_main:
        save_audio_bigan(out, state, stats, data, meta={"finetuned": args.metric, "d": d})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
