"""Generation quality of the whale BiGAN (port of ``whale_generator_score.py``):
the NARW classifier's accuracy on ``G(z, call_type)``, the call types drawn
uniformly and ``z`` from N(0, 1).

    python -m imagecfgen_torch.cli.whale_generator_score --model-dir M [--n 512] [--batch-size 64] \
        [--device cuda|cpu]

Prints ``generated call-type accuracy: ...``; needs no dataset. The
classifier's head runs through ``fused_dense`` on the card, once a batch.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="whale-bigan.tar")
parser.add_argument("--clf", type=str, default="whale-clf.tar")
parser.add_argument("--n", type=int, default=512)
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import bigan_from_state
    from .whale_common import load_whale_bigan, load_whale_classifier
    from ..models.bigan import whale_bigan_config

    state, _, meta = load_whale_bigan(os.path.join(args.model_dir, args.bigan), device)
    G = bigan_from_state(state, whale_bigan_config(d=meta.get("d", 64)), device).eval().generator
    clf, _ = load_whale_classifier(os.path.join(args.model_dir, args.clf), device)
    rng = torch.Generator().manual_seed(args.seed)  # the draws are made on the host
    correct = torch.zeros((), dtype=torch.long, device=device)
    with torch.no_grad():
        for i in range(0, args.n, args.batch_size):
            b = min(args.batch_size, args.n - i)
            labels = torch.randint(0, 3, (b,), generator=rng).to(device)
            z = torch.randn((b, 1, 1, G.cfg.latent_dim), generator=rng).to(device)
            pred = clf(G(z, {"call_type": F.one_hot(labels, 3).float()})).argmax(dim=1)
            correct += (pred == labels).sum()
    print(f"generated call-type accuracy: {correct.item() / args.n:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
