"""Where the fused kernels' float32 error comes from, on one CUDA card: each
layer of a trained AudioMNIST encoder trunk run alone through
``fused_encoder``, ``fused_dense`` on products of one sign, and the ESRF
encoder's three longest layers, each held against the same function in
float64 beside the plain float32 version.

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
several K, where every partial sum grows one way. The ESRF layers 6-8 (K =
25,600, 51,200 and 102,400 at d = 64) run at batch 2 on fan-in weights, with
the peak of device memory and the bytes of their packed weights. TF32 is
off. One JSON line per measurement, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the ESRF encoder's last three convs at d = 64, from the JAX package's
#: ``esrf_bigan_config`` (imagecfgen_tpu/models/bigan.py:288-297: eight k5 /
#: s2 / p1 convs, 512^2 -> 1, widths d .. 64 d, latent 512), which the port
#: does not have yet: (input H = W, input channels, output channels, LeakyReLU)
ESRF_LAYERS = ((15, 1024, 2048, 0.2), (7, 2048, 4096, 0.2), (3, 4096, 512, None))


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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` calls between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trunk_pairs(encoder):
    """The trunk's (kernel, bias) pairs, detached, and its parameter dict."""
    params = {n: t.detach() for n, t in encoder.trunk.named_parameters()}
    n = len(params) // 2
    return params, [(params[f"conv_{i}_kernel"], params[f"conv_{i}_bias"]) for i in range(n)]


def trunk_layers(encoder, feats, card: str):
    """Each layer of ``encoder``'s trunk alone on ``feats`` (the trunk's
    float32 input), then the whole trunk, against float64: one dict each."""
    import torch
    import torch.nn.functional as F

    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_launch_plan,
    )
    from imagecfgen_torch.ops.tensor_core import sm_count

    plan = encoder.cfg.enc_plan
    conv_ops = plan_conv_ops(plan)
    convs = [op for op in plan if op[0] == "conv"]
    params, pairs = trunk_pairs(encoder)
    dev, bsz = feats.device, feats.shape[0]
    plans = (trunk_launch_plan(tuple(feats.shape), [tuple(w.shape) for w, _ in pairs], conv_ops,
                               torch.float32, sm_count(dev)) if dev.type == "cuda" else [None] * len(pairs))
    out = []
    exact = feats.double().permute(0, 3, 1, 2)
    for i, ((stride, pad, slope), (w, b)) in enumerate(zip(conv_ops, pairs)):
        inp = exact.float().permute(0, 2, 3, 1).contiguous()
        exact = F.conv2d(inp.double().permute(0, 3, 1, 2), w.double(), b.double(), stride=stride, padding=pad)
        if slope is not None:
            exact = F.leaky_relu(exact, slope)
        one = (convs[i],) + ((("lrelu", slope),) if slope is not None else ())
        got = fused_encoder_forward({"conv_0_kernel": w, "conv_0_bias": b}, inp, one)
        plain = fused_encoder_reference(inp, [(w, b)], conv_ops[i:i + 1])
        out.append({"trunk_layer": i + 1, "batch": bsz, "k": w.shape[1] * w.shape[2] * w.shape[3],
                    "plan": plans[i] and plans[i].describe(),
                    **errors(got, plain, exact.permute(0, 2, 3, 1).reshape(bsz, -1)), "card": card})
    got, plain = fused_encoder_forward(params, feats, plan), fused_encoder_reference(feats, pairs, conv_ops)
    y = feats.double().permute(0, 3, 1, 2)  # the whole trunk in float64 from the float32 input
    for (stride, pad, slope), (w, b) in zip(conv_ops, pairs):
        y = F.conv2d(y, w.double(), b.double(), stride=stride, padding=pad)
        if slope is not None:
            y = F.leaky_relu(y, slope)
    y = y.permute(0, 2, 3, 1).reshape(bsz, -1)
    out.append({"trunk": "whole", "batch": bsz,
                "max_abs_err_f64": (got.double() - y).abs().max().item(),
                "max_abs_plain": plain.abs().max().item(), **errors(got, plain, y), "card": card})
    return out


def dense_positive(dev, seed: int, card: str, ks=(256, 1024, 4096, 16384)):
    """``fused_dense`` on U(0, 1) products, M = 128, N = 1024: one dict a K."""
    import torch

    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for k in ks:
        xs = torch.rand((128, k), generator=g).to(dev)
        ws = torch.rand((1024, k), generator=g).to(dev)
        bs = torch.zeros(1024, device=dev)
        got, plain = fused_dense_lrelu(xs, ws, bs), fused_dense_reference(xs, ws, bs)
        out.append({"dense_positive": k, **errors(got, plain, xs.double() @ ws.double().t()), "card": card})
    return out


def esrf_layers(dev, seed: int, card: str, batch: int = 2):
    """The ESRF encoder's layers 6-8 at d = 64, each alone at its own input
    shape: fan-in weights N(0, 1/fan_in), bias N(0, 0.05), LeakyReLU'd N(0, 1)
    inputs. Against its plain version (gate 1e-4 * max(1, max|plain|)) and
    float64; with the device memory's peak and the packed weights' bytes."""
    import torch
    import torch.nn.functional as F

    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_launch_plan,
    )
    from imagecfgen_torch.ops.tensor_core import cached, pack_conv_weight, sm_count

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for i, (h, ci, co, slope) in enumerate(ESRF_LAYERS):
        one = (("conv", co, 5, 2, 1),) + ((("lrelu", slope),) if slope is not None else ())
        conv_ops = plan_conv_ops(one)
        w = (torch.randn((co, ci, 5, 5), generator=g) / (25 * ci) ** 0.5).to(dev)
        b = (0.05 * torch.randn(co, generator=g)).to(dev)
        x = F.leaky_relu(torch.randn((batch, h, h, ci), generator=g), 0.2).to(dev)
        lp = trunk_launch_plan(tuple(x.shape), [tuple(w.shape)], conv_ops, torch.float32, sm_count(dev))[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        got = fused_encoder_forward({"conv_0_kernel": w, "conv_0_bias": b}, x, one)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        packed = sum(t.numel() * t.element_size() for t in cached(w, "packed_conv", pack_conv_weight))
        plain = fused_encoder_reference(x, [(w, b)], conv_ops)
        exact = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), b.double(), stride=2, padding=1)
        if slope is not None:
            exact = F.leaky_relu(exact, slope)
        exact = exact.permute(0, 2, 3, 1).reshape(batch, -1)
        err = (got - plain).abs().max().item()
        out.append({"esrf_layer": 6 + i, "batch": batch, "k": 25 * ci, "n": co, "plan": lp.describe(),
                    "max_abs_err": err, "gate": 1e-4 * max(1.0, plain.abs().max().item()),
                    "weights_bytes": w.numel() * w.element_size(), "packed_bytes": packed,
                    "max_memory_allocated": peak, **errors(got, plain, exact), "card": card})
        del w, b, x, got, plain, exact
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", default=None)
    p.add_argument("--batches", type=int, nargs="+", default=[16, 88, 256])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    from imagecfgen_torch.cli.audio_common import load_audio_bigan_model, load_audio_dataset, validation_images
    from imagecfgen_torch.cli.train_audio_mnist_bigan import main as train

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
    enc = model.encoder
    with torch.no_grad():
        for bsz in args.batches:
            a = {k: torch.from_numpy(v[:bsz]).to(dev) for k, v in av.items()}
            feats = enc.attr_channels(xv[:bsz], a).contiguous()  # (B, H, W, C) float32
            for line in trunk_layers(enc, feats, card):
                print(json.dumps(line), flush=True)
        for line in dense_positive(dev, args.seed, card):
            print(json.dumps(line), flush=True)
        if dev.type == "cuda":
            for line in esrf_layers(dev, args.seed, card):
                print(json.dumps(line), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
