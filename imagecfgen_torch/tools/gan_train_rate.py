"""Steps per second of the MNIST GAN trainer at full width on one CUDA card,
for one or more checkouts of this repo, each in a process of its own, in the
order given.

    python imagecfgen_torch/tools/gan_train_rate.py [--trees DIR ...] [--epochs 3] [--seed 0]

Each tree's own ``imagecfgen_torch`` trains ``mnist_bigan_config()`` at batch
64 with ``d_updates_per_g_update=3`` (``chip_smoke.py``'s T1) on 6,400
U(-1, 1) images held on the card, in float32 with TF32 off: one warm-up
epoch of 100 steps, then ``--epochs`` timed ones, CUDA events around each
``fit_epoch``. The step is bound by the host's launches and drifts with the
host from one machine to the next, so compare two commits in one call and
give their trees in an alternating order (``--trees old new new old``).
Prints one JSON line per tree run, then the card's name and power limit.
``--trees`` defaults to the checkout this file lies in.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS, BATCH = 100, 64


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(root: str, epochs: int, seed: int) -> dict:
    """Train in this process with ``root``'s ``imagecfgen_torch``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import imagecfgen_torch
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    where = os.path.dirname(os.path.dirname(os.path.abspath(imagecfgen_torch.__file__)))
    if where != os.path.abspath(root):
        raise RuntimeError(f"imported imagecfgen_torch from {where}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mnist_bigan_config()
    rng = np.random.default_rng(seed)
    n = STEPS * BATCH
    x = torch.from_numpy(rng.uniform(-1, 1, (n, *cfg.image_size, cfg.image_channels)).astype(np.float32))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, n)), a.n_categories).float()
             for a in cfg.attr_spec.categorical}
    attrs.update({a.name: torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
                  for a in cfg.attr_spec.continuous})
    tr = GANTrainer(BiGAN(cfg, dev, torch.Generator().manual_seed(seed + 1)),
                    GANTrainConfig(batch_size=BATCH, d_updates_per_g_update=3), seed=seed + 2)
    data = tr.upload_dataset(x.to(dev), {k: v.to(dev) for k, v in attrs.items()})
    tr.fit_epoch(data)  # warm-up: builds the kernel, fills cuDNN's caches
    rates = []
    for _ in range(epochs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = tr.fit_epoch(data)
        end.record()
        torch.cuda.synchronize()
        rates.append(STEPS / (start.elapsed_time(end) / 1e3))
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics {metrics}")
    return {"tree": root, "trainer": "GANTrainer mnist_bigan_config()", "batch": BATCH,
            "d_updates_per_g_update": 3, "steps_per_epoch": STEPS, "steps_per_s": rates}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE], help="checkouts to measure, in this order")
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs of 100 steps a tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", help=argparse.SUPPRESS)  # the worker's tree
    args = ap.parse_args(argv)
    if args.root is not None:
        print(json.dumps(measure(args.root, args.epochs, args.seed)))
        return 0
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(tree),
                              "--epochs", str(args.epochs), "--seed", str(args.seed)],
                             capture_output=True, text=True, cwd=os.path.abspath(tree))
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(f"gan_train_rate: {tree} exited with {out.returncode}", file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1])
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
