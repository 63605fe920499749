"""Times of both fused kernels at ``PERF.md`` §6's shapes, whole and layer by
layer, on one CUDA card, for one or more checkouts of this repo, each in a
process of its own, in the order given.

    python imagecfgen_torch/tools/kernel_rates.py [--trees DIR ...] [--reps 20] [--seed 0]

Each tree's own ``imagecfgen_torch`` builds its kernels and times, in float32
and in bfloat16, with CUDA events over ``--reps`` calls after a warm-up (the
call time, host included) and with ``torch.profiler`` over as many (the
device time: the kernels' own time summed):

- the four trunks at their paths' shapes: MNIST (2048, 28, 28, 5),
  AudioMNIST (128, 128, 128, 7), whale (32, 256, 256, 2) and ESRF (16, 512,
  512, 3); each of their layers alone at its own input shape; beside the
  first layer, one ``F.conv2d`` + ``F.leaky_relu`` call (TF32 off) on the
  same input, and the layer's bound;
- the MNIST trunk at the other batches its callers give it (1: the
  explainers; 32: a rank's shard; 64: the GAN's recompute; 256: the measured
  CFs) and the AudioMNIST trunk at cf-eval's 16, whole, in float32;
- ``fused_dense`` at (M, 4096) x (1024, 4096) for M = 7, 32, 64, 128 and 256,
  beside one ``F.linear`` + ``F.leaky_relu`` call, and its bound.

Weights N(0, 1/fan_in), inputs N(0, 1), from ``--seed``. A bound is the
larger of the operations over the unit's rate (a third of TF32's 495 TFLOP/s
for float32, which takes three TF32 products a product; bf16 989) and the
bytes (each input read once, the output written once) over 3.35 TB/s: an
H100 SXM's data sheet. Two machines differ, so compare two commits in one
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
RATES = {"float32": 495e12 / 3, "bfloat16": 989e12}  # FLOP/s of the unit each type uses
MEMORY = 3.35e12  # bytes/s
DENSE_ROWS = (7, 32, 64, 128, 256)
EXTRA_BATCHES = {"mnist": (1, 32, 64, 256), "audio": (16,)}  # whole trunks, float32


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, dtype: str) -> dict:
    ops, mem = flops / RATES[dtype] * 1e3, nbytes / MEMORY * 1e3
    return {"bound_ms": max(ops, mem), "bound_by": "operations" if ops >= mem else "bytes"}


def measure(root: str, reps: int, seed: int) -> dict:
    """Time in this process with ``root``'s ``imagecfgen_torch``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import imagecfgen_torch
    from imagecfgen_torch.models.bigan import (
        audio_mnist_bigan_config,
        esrf_bigan_config,
        mnist_bigan_config,
        whale_bigan_config,
    )
    from imagecfgen_torch.ops.conv import conv_out_size
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    where = os.path.dirname(os.path.dirname(os.path.abspath(imagecfgen_torch.__file__)))
    if where != os.path.abspath(root):
        raise RuntimeError(f"imported imagecfgen_torch from {where}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3 / reps

    def both(fn, prefix: str = "") -> dict:
        return {f"{prefix}ms": ms(fn), f"{prefix}device_ms": device_ms(fn)}

    out = {"tree": root, "reps": reps}
    trunks = (("mnist", mnist_bigan_config(), (2048, 28, 28, 5)),
              ("audio", audio_mnist_bigan_config(), (128, 128, 128, 7)),
              ("whale", whale_bigan_config(), (32, 256, 256, 2)),
              ("esrf", esrf_bigan_config(), (16, 512, 512, 3)))
    with torch.no_grad():
        for name, cfg, shape in trunks:
            convs = [op for op in cfg.enc_plan if op[0] == "conv"]
            params, c = {}, shape[-1]
            for i, op in enumerate(convs):
                k = op[2]
                params[f"conv_{i}_kernel"] = (torch.randn((op[1], c, k, k), generator=g) / (k * k * c) ** 0.5).to(dev)
                params[f"conv_{i}_bias"] = (0.05 * torch.randn(op[1], generator=g)).to(dev)
                c = op[1]
            feats = torch.randn(shape, generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                tag = "f32" if dtype == torch.float32 else "bf16"
                cast = {k: v.to(dtype) for k, v in params.items()}
                x = feats.to(dtype)
                trunk = both(lambda: fused_encoder_forward(cast, x, cfg.enc_plan))
                row = {"trunk_ms": trunk["ms"], "trunk_device_ms": trunk["device_ms"],
                       "layers_ms": [], "layers_device_ms": []}
                b, h, w, _ = shape
                for i, op in enumerate(convs):
                    one = (op,) + ((("lrelu", 0.2),) if i < len(convs) - 1 else ())
                    wt, bias = cast[f"conv_{i}_kernel"], cast[f"conv_{i}_bias"]
                    p1 = {"conv_0_kernel": wt, "conv_0_bias": bias}
                    xi = torch.randn((b, h, w, wt.shape[1]), generator=g).to(dev, dtype)
                    t = both(lambda: fused_encoder_forward(p1, xi, one))
                    row["layers_ms"].append(t["ms"])
                    row["layers_device_ms"].append(t["device_ms"])
                    oh, ow = conv_out_size(h, op[2], op[3], op[4]), conv_out_size(w, op[2], op[3], op[4])
                    if i == 0:  # the first layer's yardstick and bound
                        xc = xi.permute(0, 3, 1, 2)
                        lib = both(lambda: F.leaky_relu(F.conv2d(xc, wt, bias, stride=op[3], padding=op[4]), 0.2))
                        esize = xi.element_size()
                        flops = 2 * b * oh * ow * op[1] * op[2] * op[2] * wt.shape[1]
                        nbytes = esize * (xi.numel() + wt.numel() + op[1] + b * oh * ow * op[1])
                        row["first_layer"] = {"library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
                                              "flops": flops, "bytes": nbytes,
                                              **bound_ms(flops, nbytes, str(dtype).split(".")[1])}
                    h, w = oh, ow
                row["first_layer_share"] = row["layers_ms"][0] / row["trunk_ms"]
                row["first_layer_device_share"] = row["layers_device_ms"][0] / row["trunk_device_ms"]
                out[f"{name}_{tag}"] = row
                del cast, x
            for batch in EXTRA_BATCHES.get(name, ()):
                xb = torch.randn((batch,) + shape[1:], generator=g).to(dev)
                t = both(lambda: fused_encoder_forward(params, xb, cfg.enc_plan))
                out[f"{name}_f32_b{batch}"] = {"trunk_ms": t["ms"], "trunk_device_ms": t["device_ms"]}
            del params, feats
            torch.cuda.empty_cache()
        ws = (torch.randn((1024, 4096), generator=g) / 64).to(dev)
        bs = (0.05 * torch.randn(1024, generator=g)).to(dev)
        for m in DENSE_ROWS:
            xs = torch.randn((m, 4096), generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                xd, wd, bd = xs.to(dtype), ws.to(dtype), bs.to(dtype)
                kern = both(lambda: fused_dense_lrelu(xd, wd, bd))
                lib = both(lambda: F.leaky_relu(F.linear(xd, wd, bd), 0.2), "library_")
                esize = xd.element_size()
                flops, nbytes = 2 * m * 1024 * 4096, esize * (m * 4096 + 1024 * 4096 + 1024 + m * 1024)
                tag = "f32" if dtype == torch.float32 else "bf16"
                out[f"dense_{tag}_m{m}"] = {**kern, **lib, "flops": flops, "bytes": nbytes,
                                            **bound_ms(flops, nbytes, str(dtype).split(".")[1])}
        out["dense_f32_ms"] = out["dense_f32_m128"]["ms"]
        out["dense_bf16_ms"] = out["dense_bf16_m128"]["ms"]
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
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"kernel_rates: {tree} exited with {out.returncode}", file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1])
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
