"""Train a per-class (or all-class) conv autoencoder for the CF realism
metrics (port of ``train_morphomnist_ae.py``).

    python -m imagecfgen_torch.cli.train_morphomnist_ae --data-dir D \
        [--cls -1] [--epochs 200] [--latent-dim 100] [--device cuda|cpu]

``--cls`` selects one digit, ``-1`` all of them; writes ``ae-{cls}.tar``
(``ae-all.tar``).
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--cls", type=int, default=-1, help="-1 = all classes")
parser.add_argument("--epochs", "--steps", type=int, default=200)
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--latent-dim", type=int, default=100, help="AE bottleneck size")
parser.add_argument("--learning-rate", type=float, default=1e-4)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import load_mnist_training_data, save_classifier
    from ..models.classifier import AutoEncoderConfig, ConvAutoEncoder
    from ..train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    x, attrs, _ = load_mnist_training_data(args.data_dir, "train")
    if args.cls >= 0:
        x = x[attrs["digit"].argmax(axis=1) == args.cls]

    ae = ConvAutoEncoder(AutoEncoderConfig(latent_dim=args.latent_dim), device,
                         torch.Generator().manual_seed(args.seed))
    trainer = SupervisedTrainer(
        ae, SupervisedTrainConfig(batch_size=args.batch_size, loss="mse",
                                  learning_rate=args.learning_rate),
        device, seed=args.seed + 1, mesh=mesh,
    )
    data = trainer.upload_dataset(x, x)
    for epoch in range(args.epochs):
        metrics = trainer.fit_epoch(data)
        if (epoch + 1) % 10 == 0 or epoch + 1 == args.epochs:
            print(f"epoch {epoch + 1}/{args.epochs}: mse={metrics['loss']:.5f}")

    name = "all" if args.cls < 0 else str(args.cls)
    out_dir = args.output_path or "."
    out = os.path.join(out_dir, f"ae-{name}.tar")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_classifier(out, trainer.state_dict(), meta={"kind": "mnist-ae", "cls": args.cls})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
