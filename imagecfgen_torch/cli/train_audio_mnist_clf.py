"""Train an AudioMNIST attribute classifier (port of
``train_audio_mnist_clf.py``): digit, gender, accent, country_of_origin,
native_speaker, age, or the 60-way ``subject`` head of the
identity-preservation metric.

    python -m imagecfgen_torch.cli.train_audio_mnist_clf [--zip-path Z] \
        [--attribute digit] [--epochs 30] [--width 1.0] [--output-path O] [--device cuda|cpu]

Trains on normalised spectrograms of the training runs (the head's dense ->
LeakyReLU runs in the ``fused_dense`` kernel on the card, its backward as
matmuls), reports ``val_acc`` on the validation runs every fifth epoch and
writes ``audio-mnist-{attribute}-clf.tar`` with the spectrogram statistics.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--zip-path", type=str, default=None)
parser.add_argument("--attribute", type=str, default="digit")
parser.add_argument("--epochs", type=int, default=30)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--l-rate", type=float, default=1e-4)
parser.add_argument("--output-path", type=str, default="")
parser.add_argument("--normalize", action="store_true", default=True,
                    help="train on spect_to_img normalised inputs")
parser.add_argument("--width", type=float, default=1.0,
                    help="channel-width multiplier (1.0 = reference widths)")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from .common import data_parallel

    mesh, device = data_parallel(args.device)
    from .audio_common import load_audio_dataset, prepare_training_arrays, save_audio_classifier, validation_images
    from ..models.classifier import CNNClassifier, audio_mnist_classifier_config
    from ..train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    data = load_audio_dataset(args.zip_path)
    x, attrs, stats = prepare_training_arrays(data, device=device)
    if args.attribute == "subject":
        idx = data.split_indices(excluded_runs=data.training_excluded_runs)
        y = np.eye(60, dtype=np.float32)[data.raw["subject"][idx] - 1]  # 0-based 60-way
    else:
        y = attrs[args.attribute].astype(np.float32)
    n_classes = y.shape[1]

    clf = CNNClassifier(audio_mnist_classifier_config(n_classes, width=args.width), device,
                        torch.Generator().manual_seed(args.seed))
    trainer = SupervisedTrainer(clf, SupervisedTrainConfig(learning_rate=args.l_rate,
                                                           batch_size=args.batch_size),
                                device, seed=args.seed + 1, mesh=mesh)
    xv, v_attrs, vidx = validation_images(data, stats, device)
    yv = data.raw["subject"][vidx] - 1 if args.attribute == "subject" else v_attrs[args.attribute].argmax(axis=1)

    train = trainer.upload_dataset(x, y)
    del x
    for epoch in range(args.epochs):
        metrics = trainer.fit_epoch(train)
        msg = f"epoch {epoch + 1}/{args.epochs}: loss={metrics['loss']:.4f}"
        if len(xv) and (epoch + 1) % 5 == 0:
            msg += f" val_acc={trainer.accuracy(xv, yv):.4f}"
        print(msg)

    out_dir = args.output_path or "."
    out = os.path.join(out_dir, f"audio-mnist-{args.attribute}-clf.tar")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_audio_classifier(out, trainer.state_dict(), stats,
                              {"attribute": args.attribute, "n_classes": n_classes, "width": args.width})
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
