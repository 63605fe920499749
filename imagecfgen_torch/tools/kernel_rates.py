"""Times of both fused kernels at ``PERF.md`` §6's shapes, whole and layer by
layer, on one CUDA card, for one or more checkouts of this repo, each in a
process of its own, in the order given.

    python imagecfgen_torch/tools/kernel_rates.py [--trees DIR ...] [--reps 20] [--seed 0]

Each tree's own ``imagecfgen_torch`` builds its kernels and times, with CUDA
events over ``--reps`` calls after a warm-up, in float32 and in bfloat16:
the MNIST trunk at (2048, 28, 28, 5), the AudioMNIST trunk at (128, 128,
128, 7), each of their layers alone at its own input shape, and
``fused_dense`` at (128, 4096) x (1024, 4096); weights N(0, 1/fan_in), inputs
N(0, 1), from ``--seed``. Two machines differ, so compare two commits in one
call with their trees in an alternating order (``--trees old new new old``).
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(root: str, reps: int, seed: int) -> dict:
    """Time in this process with ``root``'s ``imagecfgen_torch``."""
    sys.path.insert(0, root)
    import torch

    import imagecfgen_torch
    from imagecfgen_torch.models.bigan import audio_mnist_bigan_config, mnist_bigan_config
    from imagecfgen_torch.ops.conv import conv_out_size
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    where = os.path.dirname(os.path.dirname(os.path.abspath(imagecfgen_torch.__file__)))
    if where != os.path.abspath(root):
        raise RuntimeError(f"imported imagecfgen_torch from {where}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)

    def ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": root, "reps": reps}
    with torch.no_grad():
        for name, cfg, shape in (("mnist", mnist_bigan_config(), (2048, 28, 28, 5)),
                                 ("audio", audio_mnist_bigan_config(), (128, 128, 128, 7))):
            convs = [op for op in cfg.enc_plan if op[0] == "conv"]
            params, c = {}, shape[-1]
            for i, op in enumerate(convs):
                k = op[2]
                params[f"conv_{i}_kernel"] = (torch.randn((op[1], c, k, k), generator=g) / (k * k * c) ** 0.5).to(dev)
                params[f"conv_{i}_bias"] = (0.05 * torch.randn(op[1], generator=g)).to(dev)
                c = op[1]
            feats = torch.randn(shape, generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                cast = {k: v.to(dtype) for k, v in params.items()}
                x = feats.to(dtype)
                row = {"trunk_ms": ms(lambda: fused_encoder_forward(cast, x, cfg.enc_plan)), "layers_ms": []}
                b, h, w, _ = shape
                for i, op in enumerate(convs):
                    one = (op,) + ((("lrelu", 0.2),) if i < len(convs) - 1 else ())
                    p1 = {"conv_0_kernel": cast[f"conv_{i}_kernel"], "conv_0_bias": cast[f"conv_{i}_bias"]}
                    xi = torch.randn((b, h, w, p1["conv_0_kernel"].shape[1]), generator=g).to(dev, dtype)
                    row["layers_ms"].append(ms(lambda: fused_encoder_forward(p1, xi, one)))
                    h, w = conv_out_size(h, op[2], op[3], op[4]), conv_out_size(w, op[2], op[3], op[4])
                out[f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}"] = row
        xs = torch.randn((128, 4096), generator=g).to(dev)
        ws = (torch.randn((1024, 4096), generator=g) / 64).to(dev)
        bs = torch.zeros(1024, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd, bd = xs.to(dtype), ws.to(dtype), bs.to(dtype)
            out[f"dense_{'f32' if dtype == torch.float32 else 'bf16'}_ms"] = ms(lambda: fused_dense_lrelu(xd, wd, bd))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE], help="checkouts to measure, in this order")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", help=argparse.SUPPRESS)  # the worker's tree
    args = ap.parse_args(argv)
    if args.root is not None:
        print(json.dumps(measure(args.root, args.reps, args.seed)))
        return 0
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(tree),
                              "--reps", str(args.reps), "--seed", str(args.seed)],
                             capture_output=True, text=True, cwd=os.path.abspath(tree))
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(f"kernel_rates: {tree} exited with {out.returncode}", file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1])
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
