"""Train the NARW call-type classifier (port of ``train_whale_clf.py``): the
8-conv CNN over 256^2 spectrograms, cross-entropy over the three call types.

    python -m imagecfgen_torch.cli.train_whale_clf [--nocall-dir N --shotgun-dir S --upcall-dir U] \
        [--epochs 30] [--width 1.0] [--output-path O] [--device cuda|cpu]

Trains on the training windows' normalised spectrograms, computed on the
device (the head's dense -> LeakyReLU runs in the ``fused_dense`` kernel on
the card, its backward as matmuls), reports ``val_acc`` every fifth epoch
and writes ``whale-clf.tar`` with the statistics and the width. Without the
recordings it trains on the synthetic stand-in.
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
parser.add_argument("--epochs", type=int, default=30)
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--filter-length", type=int, default=None)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--width", type=float, default=1.0)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .whale_common import collect_whale_arrays, load_whale_dataset, save_whale_classifier
    from ..models.classifier import CNNClassifier, narw_classifier_config
    from ..train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    data = load_whale_dataset(args.nocall_dir, args.shotgun_dir, args.upcall_dir,
                              filter_length=args.filter_length, synthetic_clips=args.synthetic_clips)
    x, y, stats = collect_whale_arrays(data, "train", device=device)
    xv, yv_onehot, _ = collect_whale_arrays(data, "validation", device=device)
    yv = yv_onehot.argmax(axis=1)

    clf = CNNClassifier(narw_classifier_config(3, width=args.width), device,
                        torch.Generator().manual_seed(args.seed))
    trainer = SupervisedTrainer(clf, SupervisedTrainConfig(learning_rate=args.l_rate, batch_size=args.batch_size),
                                device, seed=args.seed + 1, mesh=mesh)
    train = trainer.upload_dataset(x, y)
    del x
    for epoch in range(args.epochs):
        metrics = trainer.fit_epoch(train)
        msg = f"epoch {epoch + 1}/{args.epochs}: loss={metrics['loss']:.4f}"
        if len(xv) and (epoch + 1) % 5 == 0:
            msg += f" val_acc={trainer.accuracy(xv, yv):.4f}"
        print(msg)

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, "whale-clf.tar")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_whale_classifier(out, trainer.state_dict(), stats, args.width)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
