"""Train the MNIST digit classifier, the CF metrics' oracle (port of
``train_mnist_clf.py``): cross-entropy on [-1, 1]-scaled images, Adam 1e-4.

    python -m imagecfgen_torch.cli.train_mnist_clf --data-dir D \
        [--output-path O] [--epochs 10] [--device cuda|cpu]

Writes ``mnist_clf.tar`` (``--output-name``); reports ``val_acc`` every fifth
epoch when the data has a test split.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--epochs", type=int, default=10)
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--output-name", type=str, default="mnist_clf.tar",
                    help="e.g. mnist_clf_raw.tar when training on plain MNIST")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .common import has_test_split, load_mnist_training_data, save_classifier
    from ..models.classifier import CNNClassifier, mnist_classifier_config
    from ..train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    x, attrs, _ = load_mnist_training_data(args.data_dir, "train")
    x_test = y_test = None
    if has_test_split(args.data_dir):
        x_test, attrs_test, _ = load_mnist_training_data(args.data_dir, "test")
        y_test = attrs_test["digit"].argmax(axis=1)

    clf = CNNClassifier(mnist_classifier_config(), device, torch.Generator().manual_seed(args.seed))
    trainer = SupervisedTrainer(clf, SupervisedTrainConfig(batch_size=args.batch_size), device,
                                seed=args.seed + 1, mesh=mesh)
    data = trainer.upload_dataset(x, attrs["digit"])
    for epoch in range(args.epochs):
        metrics = trainer.fit_epoch(data)
        msg = f"epoch {epoch + 1}/{args.epochs}: loss={metrics['loss']:.4f}"
        if x_test is not None and (epoch + 1) % 5 == 0:
            msg += f" val_acc={trainer.accuracy(x_test, y_test):.4f}"
        print(msg)

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, args.output_name)
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_classifier(out, trainer.state_dict(), meta={"kind": "mnist-clf"})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
