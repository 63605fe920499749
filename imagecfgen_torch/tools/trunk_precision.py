"""Where the fused kernels' float32 error comes from, on one CUDA card: each
layer of a trained AudioMNIST encoder trunk run alone through
``fused_encoder``, and ``fused_dense`` on products of one sign, each held
against the same function in float64 beside the plain float32 version.

    python imagecfgen_torch/tools/trunk_precision.py [--model-dir DIR] [--batches 16 88 256]

``--model-dir`` holds an ``audio-mnist-bigan.tar``; without it, one epoch of
``train_audio_mnist_bigan`` (d = 64, batch 128, ``--init-std 0.01``, the
synthetic stand-in, as ``chip_smoke.py``'s AU2) trains one in a temporary
directory. Each layer's input is the float64 activation of the layers before
it, rounded to float32, on the first B validation clips. For each layer and
batch it prints, relative to max |float64|: the largest error of the kernel
and of the plain version, and their mean signed error toward zero,
``mean(|out| - |exact|)`` (negative: the results are pulled toward zero).
The ``fused_dense`` probe multiplies U(0, 1) matrices, M = 128, N = 1024, at
several K, where every partial sum grows one way. TF32 is off. One JSON line
per measurement, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def errors(out, plain, exact) -> dict:
    """Max and mean signed-toward-zero errors of ``out`` and ``plain``
    against ``exact`` (float64), relative to max |exact|."""
    top = exact.abs().max().item()
    res = {"max_abs_exact": top}
    for name, t in (("kernel", out), ("plain", plain)):
        t = t.double()
        res[f"{name}_max_err"] = (t - exact).abs().max().item() / top
        res[f"{name}_toward_zero"] = (t.abs() - exact.abs()).mean().item() / top
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", default=None)
    p.add_argument("--batches", type=int, nargs="+", default=[16, 88, 256])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    from imagecfgen_torch.cli.audio_common import load_audio_bigan_model, load_audio_dataset, validation_images
    from imagecfgen_torch.cli.train_audio_mnist_bigan import main as train
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_launch_plan,
    )
    from imagecfgen_torch.ops.tensor_core import sm_count

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("trunk_precision: no CUDA card (--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line() if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = args.model_dir or tmp
        if args.model_dir is None:
            code = train(["--output-path", tmp, "--steps", "1", "--d", "64", "--init-std", "0.01",
                          "--batch-size", "128", "--seed", str(args.seed), "--device", dev.type])
            if code != 0:
                return code
        model, stats, _ = load_audio_bigan_model(os.path.join(model_dir, "audio-mnist-bigan.tar"), dev)
    data = load_audio_dataset(None)
    xv, av, _ = validation_images(data, stats, dev)
    enc, plan = model.encoder, model.encoder.cfg.enc_plan
    conv_ops = plan_conv_ops(plan)
    convs = [op for op in plan if op[0] == "conv"]
    params = {n: t.detach() for n, t in enc.trunk.named_parameters()}
    pairs = [(params[f"conv_{i}_kernel"], params[f"conv_{i}_bias"]) for i in range(len(convs))]

    with torch.no_grad():
        for bsz in args.batches:
            a = {k: torch.from_numpy(v[:bsz]).to(dev) for k, v in av.items()}
            x = enc.attr_channels(xv[:bsz], a).contiguous()  # (B, H, W, C) float32
            exact = x.double().permute(0, 3, 1, 2)
            plans = (trunk_launch_plan(tuple(x.shape), [tuple(w.shape) for w, _ in pairs], conv_ops,
                                       torch.float32, sm_count(dev)) if dev.type == "cuda" else [None] * len(pairs))
            for i, ((stride, pad, slope), (w, b)) in enumerate(zip(conv_ops, pairs)):
                inp = exact.float().permute(0, 2, 3, 1).contiguous()
                exact = F.conv2d(inp.double().permute(0, 3, 1, 2), w.double(), b.double(),
                                 stride=stride, padding=pad)
                if slope is not None:
                    exact = F.leaky_relu(exact, slope)
                one = (convs[i],) + ((("lrelu", slope),) if slope is not None else ())
                single = {"conv_0_kernel": w, "conv_0_bias": b}
                out = fused_encoder_forward(single, inp, one)
                plain = fused_encoder_reference(inp, [(w, b)], conv_ops[i:i + 1])
                line = {"trunk_layer": i + 1, "batch": bsz, "k": w.shape[1] * w.shape[2] * w.shape[3],
                        "plan": plans[i] and plans[i].describe(),
                        **errors(out, plain, exact.permute(0, 2, 3, 1).reshape(bsz, -1)), "card": card}
                print(json.dumps(line), flush=True)
            out, plain = fused_encoder_forward(params, x, plan), fused_encoder_reference(x, pairs, conv_ops)
            y = x.double().permute(0, 3, 1, 2)  # the whole trunk in float64 from the float32 input
            for (stride, pad, slope), (w, b) in zip(conv_ops, pairs):
                y = F.conv2d(y, w.double(), b.double(), stride=stride, padding=pad)
                if slope is not None:
                    y = F.leaky_relu(y, slope)
            print(json.dumps({"trunk": "whole", "batch": bsz,
                              **errors(out, plain, y.permute(0, 2, 3, 1).reshape(bsz, -1)), "card": card}),
                  flush=True)
        g = torch.Generator(device="cpu").manual_seed(args.seed)
        for k in (256, 1024, 4096, 16384):
            xs = torch.rand((128, k), generator=g).to(dev)
            ws = torch.rand((1024, k), generator=g).to(dev)
            bs = torch.zeros(1024, device=dev)
            out, plain = fused_dense_lrelu(xs, ws, bs), fused_dense_reference(xs, ws, bs)
            print(json.dumps({"dense_positive": k, **errors(out, plain, xs.double() @ ws.double().t()),
                              "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
