"""Train the ten binary per-digit oracle classifiers with BCE (port of
``train_morphomnist_oracles.py``).

    python -m imagecfgen_torch.cli.train_morphomnist_oracles --data-dir D \
        [--output-path O] [--epochs 20] [--device cuda|cpu]

Oracle ``d`` learns "is this digit d" on the training split through the
port's ``SupervisedTrainer`` (``loss="bce"``, ``mnist_oracle_config``);
writes ``oracle-{d}.tar`` for each digit and prints its accuracy on the
first 2,048 training rows.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--epochs", type=int, default=20)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import load_mnist_training_data, save_classifier
    from ..models.classifier import CNNClassifier, mnist_oracle_config
    from ..train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    x, attrs, _ = load_mnist_training_data(args.data_dir, "train")
    digits = attrs["digit"].argmax(axis=1)

    out_dir = args.output_path or "."
    os.makedirs(out_dir, exist_ok=True)
    for d in range(10):
        y = (digits == d).astype(np.float32).reshape(-1, 1)
        clf = CNNClassifier(mnist_oracle_config(), device, torch.Generator().manual_seed(args.seed + d))
        trainer = SupervisedTrainer(clf, SupervisedTrainConfig(batch_size=args.batch_size, loss="bce"),
                                    device, seed=args.seed + 100 + d, mesh=mesh)
        data = trainer.upload_dataset(x, y)
        for _ in range(args.epochs):
            trainer.fit_epoch(data)
        pred = trainer.predict(x[:2048])[:, 0] > 0
        acc = (pred.cpu().numpy() == (y[:2048, 0] > 0.5)).mean()
        out = os.path.join(out_dir, f"oracle-{d}.tar")
        if mesh.is_main:
            save_classifier(out, trainer.state_dict(), meta={"kind": "mnist-oracle", "digit": d})
        print(f"oracle {d}: train acc {acc:.4f} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
