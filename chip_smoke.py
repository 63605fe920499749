"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--seed 0] [--batch 2048]

Phases (any failure ends the run with a non-zero exit):

1. set-up: the card's name and power limit, TF32 off, build of the CUDA
   kernels from ``imagecfgen_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's shapes
   (the full-width ``mnist_bigan_config()`` encoder trunk at ``--batch``);
3. the main path end to end: ``CounterfactualEngine.counterfactual`` with
   ``do(thickness + 2)`` and ``reconstruct`` at full width, with the kernels'
   launch counts read around that run only;
4. times with CUDA events: each kernel, its plain version, the PyTorch
   library stack computing the same function, and the engine's rate.

The last line of output is ``{"ok": true, "device": {...}}``; the line before
it is ``nvidia-smi``'s name and power limit of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# f32 rates of the CUDA cores (TFLOP/s) and memory rates (TB/s) from NVIDIA's
# data sheets, by a substring of torch.cuda.get_device_name()
PEAKS = (
    ("H100 PCIe", 51.2, 2.0),
    ("H100 NVL", 60.0, 3.9),
    ("H200", 67.0, 4.8),
    ("H100", 67.0, 3.35),  # SXM: "NVIDIA H100 80GB HBM3"
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond, msg: str) -> None:
    """Fail the run (independent of ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def peaks(name: str):
    for key, tflops, tbs in PEAKS:
        if key in name:
            return tflops * 1e12, tbs * 1e12
    raise RuntimeError(f"no peak rates known for {name!r}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events, after a
    warm-up; a hard sync closes the timed region."""
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


def trunk_params(plan, seed: int, dev):
    """Full-width trunk weights drawn with numpy at N(0, 0.05), in the
    port's layout."""
    rng = np.random.default_rng(seed)
    c_in, params, i = 5, {}, 0
    for op in plan:
        if op[0] != "conv":
            continue
        ch, k = op[1], op[2]
        w = rng.normal(0, 0.05, (ch, c_in, k, k)).astype(np.float32)
        params[f"conv_{i}_kernel"] = torch.from_numpy(w).to(dev)
        params[f"conv_{i}_bias"] = torch.from_numpy(rng.normal(0, 0.05, ch).astype(np.float32)).to(dev)
        c_in, i = ch, i + 1
    return params


def trunk_cost(feats_shape, pairs, conv_ops):
    """(FLOPs, bytes) the trunk must do and move: each input read once, each
    output written once."""
    from imagecfgen_torch.ops.conv import conv_out_size

    b, h, w, c = feats_shape
    flops, nbytes = 0, 4 * b * h * w * c
    for (stride, pad, _), (wt, bias) in zip(conv_ops, pairs):
        co, ci, k, _ = wt.shape
        h, w = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad)
        flops += 2 * b * h * w * co * ci * k * k
        nbytes += 4 * (wt.numel() + bias.numel())
    return flops, nbytes + 4 * b * h * w * co


def library_stack(feats, pairs, conv_ops):
    """The same function as PyTorch library calls (cuDNN convs on a
    channels-last view): the yardstick, never called by the port."""
    x = feats.permute(0, 3, 1, 2)
    for (stride, pad, slope), (w, b) in zip(conv_ops, pairs):
        x = F.conv2d(x, w, b, stride=stride, padding=pad)
        if slope is not None:
            x = F.leaky_relu(x, slope)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def engine_stages_ms(engine, x, attrs, do):
    """Device time of the engine's stages on one batch: attribute SCM
    (abduct-act-predict on the attributes), encoder, generator."""
    scm, scaler = engine.scm, engine.scaler
    obs = engine._to_graph_obs(attrs)
    cf = engine._to_model_attrs(scm.graph.sample_cf(scm.params, scm.state, None, obs, do))
    a, a_cf = scaler.scale(attrs), scaler.scale(cf)
    z = engine.bigan.encoder(x, a)
    return {
        "attribute_scm": time_ms(lambda: engine._to_model_attrs(
            scm.graph.sample_cf(scm.params, scm.state, None, obs, do)), reps=10),
        "scaling": time_ms(lambda: (scaler.scale(attrs), scaler.scale(cf)), reps=10),
        "encoder": time_ms(lambda: engine.bigan.encoder(x, a), reps=10),
        "generator": time_ms(lambda: engine.bigan.generator(z, a_cf), reps=10),
    }


def profile_engine(engine, x, attrs, do):
    """torch.profiler over one counterfactual batch: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.counterfactual(x, attrs, do)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    print("profile: chiprun_out/chip_smoke_profile.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--profile", action="store_true",
                    help="also write a torch.profiler table of one counterfactual "
                         "batch to chiprun_out/chip_smoke_profile.txt")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeScaler
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.ops import _build
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_weights,
    )
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    # ---------------------------------------------------------- 1. set-up
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load_library("fused_encoder")
    print(f"build: fused_encoder in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in _build.BUILD_LOG.items():
        print(f"nvcc {lib}: {secs:.2f} s")
        for chunk in log.split("Compiling entry function")[1:]:
            tmpl = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", chunk)
            spills = re.search(r"(\d+) bytes spill stores", chunk)
            used = re.search(r"Used (\d+) registers.*", chunk)
            print(f"  kernel {tmpl.groups() if tmpl else '?'} (ks, BM, BN, TM, TN): "
                  f"{used.group(0) if used else '?'}, {spills.group(0) if spills else '?'}")

    # ---------------------------------------------- 2. kernel against plain
    b = args.batch
    cfg = mnist_bigan_config()
    plan = cfg.enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev)
    flat = trunk_weights(params)
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(conv_ops))]
    rng = np.random.default_rng(args.seed + 1)
    feats = torch.from_numpy(rng.normal(0, 1, (b, 28, 28, 5)).astype(np.float32)).to(dev)
    plain = fused_encoder_reference(feats, pairs, conv_ops)
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    errs = {}
    for split in (0, 2):
        out = fused_encoder_forward(params, feats, plan, split=split)
        torch.cuda.synchronize()
        check(out.shape == plain.shape == (b, cfg.latent_dim), f"kernel output shape {tuple(out.shape)}")
        errs[split] = (out - plain).abs().max().item()
        print(f"fused_encoder split={split}: max|kernel - plain| = {errs[split]:.3e} (tol {tol:.3e})")
        check(errs[split] <= tol, f"fused_encoder split={split} disagrees with its plain version")

    # ------------------------------------------------- 3. the main path
    g = torch.Generator().manual_seed(args.seed)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, b) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, b)).astype(np.float32)
    digit = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    raw = {"digit": digit, "thickness": t, "intensity": i, "slant": s}
    scaler = AttributeScaler.fit(MNIST_SPEC, raw)
    graph = build_mnist_graph(i.min(), i.max(), s.min(), s.max())
    scm = MNISTAttributeSCM(graph, *graph.init(g, dev))
    engine = CounterfactualEngine(BiGAN(cfg, dev, g), scm, scaler)
    xd = torch.from_numpy(x).to(dev)
    attrs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    do = {"thickness": torch.from_numpy(t + 2).reshape(-1, 1).to(dev)}

    fused_encoder_forward.launches = 0
    x_cf, cf_attrs = engine.counterfactual(xd, attrs, do)
    recon = engine.reconstruct(xd, attrs)
    torch.cuda.synchronize()
    launches = fused_encoder_forward.launches
    print(f"main path: fused_encoder launched {launches} times")
    check(launches > 0, "the main path did not reach the fused_encoder kernel")

    for img in (x_cf, recon):
        check(img.shape == (b, 28, 28, 1), f"image shape {tuple(img.shape)}")
        check(torch.isfinite(img).all(), "non-finite image")
        check(img.abs().max().item() <= 1.0, "image outside [-1, 1]")
    check(sorted(cf_attrs) == sorted(raw), f"counterfactual attributes {sorted(cf_attrs)}")
    check(all(torch.isfinite(v).all() for v in cf_attrs.values()), "non-finite attribute")
    check(torch.equal(cf_attrs["thickness"], do["thickness"].reshape(-1)), "do(thickness) lost")
    check(torch.equal(cf_attrs["digit"], attrs["digit"]), "digit changed without an intervention")
    check((cf_attrs["intensity"] - attrs["intensity"]).abs().max().item() > 0, "intensity ignored its parent")

    with torch.no_grad():
        enc = engine.bigan.encoder
        scaled = scaler.scale(attrs)
        z = enc(xd, scaled).reshape(b, -1)
        ef = enc.attr_channels(xd, scaled)
        eflat = trunk_weights(dict(enc.trunk.named_parameters()))
        epairs = [(eflat[2 * j], eflat[2 * j + 1]) for j in range(len(conv_ops))]
        zp = fused_encoder_reference(ef, epairs, conv_ops)
    z_err = (z - zp).abs().max().item()
    z_tol = 1e-4 * max(1.0, zp.abs().max().item())
    print(f"engine z: max|kernel - plain| = {z_err:.3e} (tol {z_tol:.3e})")
    check(z_err <= z_tol, "the engine's encoder disagrees with the plain trunk")

    # --------------------------------------------------------- 4. times
    with torch.no_grad():
        kernel_ms = time_ms(lambda: fused_encoder_forward(params, feats, plan))
        plain_ms = time_ms(lambda: fused_encoder_reference(feats, pairs, conv_ops))
        library_ms = time_ms(lambda: library_stack(feats, pairs, conv_ops))
        lib_err = (library_stack(feats, pairs, conv_ops) - plain).abs().max().item()
        check(lib_err <= tol, f"library stack disagrees with the plain version ({lib_err:.3e})")
        cf_ms = time_ms(lambda: engine.counterfactual(xd, attrs, do), reps=10, warmup=2)
        stages_ms = engine_stages_ms(engine, xd, attrs, do)
    flops, nbytes = trunk_cost(tuple(feats.shape), pairs, conv_ops)
    peak_flops, peak_bw = peaks(name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    kernels = [{
        "name": "fused_encoder",
        "route": "cuda",
        "source": "imagecfgen_torch/csrc/fused_encoder.cu",
        "replaces": "imagecfgen_tpu/ops/pallas/fused_encoder.py:127",
        "launches": launches,
        "max_abs_err": errs[0],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "batch": b,
        "flops": flops,
        "bytes": nbytes,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "engine": "counterfactual do(thickness+2)",
        "batch": b,
        "ms_per_batch": cf_ms,
        "images_per_s": b / (cf_ms / 1e3),
        "stages_ms": stages_ms,
        "card": card,
    }))
    if args.profile:
        profile_engine(engine, xd, attrs, do)

    # ---------------------------------------------------------- 5. the end
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
