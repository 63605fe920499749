"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--seed 0] [--batch 2048] [--audio-batch 128]
                          [--mc-rounds 4] [--profile]

Phases (any failure ends the run with a non-zero exit):

1. set-up: the card's name and power limit, TF32 off, build of the CUDA
   kernels from ``imagecfgen_torch/csrc`` (one ``nvcc`` each, in parallel);
2. each kernel against its plain PyTorch version at the MNIST path's shapes
   (the full-width ``mnist_bigan_config()`` encoder trunk at ``--batch``);
3. the MNIST path end to end: ``CounterfactualEngine.counterfactual`` with
   ``do(thickness + 2)`` and ``reconstruct`` at full width, with the kernels'
   launch counts read around that run only;
4. times with CUDA events: each kernel, its plain version, the PyTorch
   library stack computing the same function, and the engine's rate;

and for the AudioMNIST scoring path (``--audio-batch``):

A2. ``fused_dense`` against its plain version at the classifier head's
    shape (``--audio-batch``, 4096, 1024) and at ragged shapes, and
    ``fused_encoder`` on the full-width ``audio_mnist_bigan_config()``
    encoder trunk (5x5 kernels, 7 input channels, 128^2 input);
A3. the path end to end: ``cf_effectiveness_score`` (target ``digit``,
    ``--mc-rounds`` rounds) over the full-width AudioMNIST BiGAN, attribute
    SCM and classifier, with both kernels' launch counts read around that
    run only; then one counterfactual with a resampled digit, checked
    attribute by attribute, and the classifier against its plain head;
A4. times: each kernel at the path's shapes beside its plain version, the
    library call and its bound, and the score's rate with its stages.

The ``kernels`` line lists every kernel row; the last line of output is
``{"ok": true, "device": {...}}``; the line before it is ``nvidia-smi``'s
name and power limit of the card.
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

# where --profile writes its tables
PROFILE_DIR = "chiprun_out"

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


def device_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn``, summed over the kernels that
    torch.profiler records in ``reps`` calls after a warm-up: the time
    without the host's launch overhead, which ``time_ms`` includes when the
    host, not the device, sets the pace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / reps


def trunk_params(plan, seed: int, dev, c_in: int = 5, std=0.05):
    """Full-width trunk weights drawn with numpy at N(0, std) (``std=None``:
    1/sqrt(fan_in)), in the port's layout."""
    rng = np.random.default_rng(seed)
    params, i = {}, 0
    for op in plan:
        if op[0] != "conv":
            continue
        ch, k = op[1], op[2]
        sd = 1 / np.sqrt(c_in * k * k) if std is None else std
        w = rng.normal(0, sd, (ch, c_in, k, k)).astype(np.float32)
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


def profile_path(fn, filename: str) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel, as a
    table in ``PROFILE_DIR/<filename>``, and the device's busy time against
    the profiled call's host-clock time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, filename), "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    print(f"profile: {PROFILE_DIR}/{filename}; device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle {1 - busy_ms / wall_ms:.1%}), {sum(e.count for e in device)} kernels")


def mangled_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (``_ZN...``)."""
    i, name = 3, "?"
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return name


def kernel_lines(log: str):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name, template
    arguments, registers and spills."""
    for chunk in log.split("Compiling entry function")[1:]:
        mangled = chunk.split("'")[1] if "'" in chunk else ""
        targs = re.findall(r"L[ib](\d+)E", mangled)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        used = re.search(r"Used (\d+) registers.*", chunk)
        yield (f"  kernel {mangled_name(mangled)}<{','.join(targs)}>: "
               f"{used.group(0) if used else '?'}, {spills.group(0) if spills else '?'}")


def plan_flops(plan, in_shape) -> int:
    """FLOPs per sample (two per multiply-add) of a plan's convs,
    transposed convs and dense layers."""
    from imagecfgen_torch.ops.conv import conv_out_size, conv_transpose_out_size

    shape, flops = tuple(in_shape), 0
    for op in plan:
        if op[0] in ("conv", "convT"):
            (h, w, c), (co, k, st, p) = shape, op[1:5]
            if op[0] == "conv":
                oh, ow = conv_out_size(h, k, st, p), conv_out_size(w, k, st, p)
                flops += 2 * oh * ow * co * c * k * k
            else:  # every input pixel scatters into k*k outputs
                outpad = op[5] if len(op) > 5 else 0
                oh, ow = (conv_transpose_out_size(h, k, st, p, outpad),
                          conv_transpose_out_size(w, k, st, p, outpad))
                flops += 2 * h * w * co * c * k * k
            shape = (oh, ow, co)
        elif op[0] == "dense":
            flops += 2 * shape[-1] * op[1]
            shape = (op[1],)
        elif op[0] == "flatten":
            shape = (int(np.prod(shape)),)
        elif op[0] == "reshape":
            shape = tuple(op[1])
    return flops


def row(name, source, replaces, launches, err, kernel_ms, plain_ms, library_ms,
        flops, nbytes, peak, card, **extra):
    """One entry of the ``kernels`` line; the bound is the larger of the
    operations over the f32 rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak[0] * 1e3, nbytes / peak[1] * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, **extra, "flops": flops, "bytes": nbytes, "card": card,
    }


def dense_cost(m: int, k: int, n: int):
    """(FLOPs, bytes) of ``lrelu(x @ w.T + b)``: each input read once, the
    output written once."""
    return 2 * m * n * k, 4 * (m * k + n * k + n + m * n)


def audio_phases(args, dev, card, peak):
    """Phases A2-A4: the AudioMNIST scoring path. Returns (kernel rows,
    score line)."""
    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.core.attributes import AttributeScaler
    from imagecfgen_torch.metrics.scores import cf_effectiveness_score, resample_excluding
    from imagecfgen_torch.models import layers
    from imagecfgen_torch.models.bigan import AUDIO_MNIST_SPEC, BiGAN, audio_mnist_bigan_config
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_weights,
    )
    from imagecfgen_torch.scm.audio_mnist import AudioMNISTAttributeSCM, build_audio_mnist_graph

    b = args.audio_batch
    rng = np.random.default_rng(args.seed + 2)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # ------------------------------- A2. kernels against their plain versions
    head = (b, 4096, 1024)
    dense_in, dense_errs = {}, {}
    for m, k, n in (head, (100, 300, 200), (100, 3000, 200)):
        x = tensor(rng.normal(0, 1, (m, k)))
        w = tensor(rng.normal(0, 1 / np.sqrt(k), (n, k)))
        bias = tensor(rng.normal(0, 0.5, n))
        plain = fused_dense_reference(x, w, bias, 0.2)
        out = fused_dense_lrelu(x, w, bias, 0.2)
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, plain.abs().max().item())
        dense_errs[(m, k, n)] = err = (out - plain).abs().max().item()
        print(f"fused_dense {m}x{k}x{n}: max|kernel - plain| = {err:.3e} (tol {tol:.3e})")
        check(out.shape == plain.shape == (m, n), f"fused_dense output shape {tuple(out.shape)}")
        check(err <= tol, f"fused_dense {m}x{k}x{n} disagrees with its plain version")
        dense_in[(m, k, n)] = (x, w, bias)

    cfg = audio_mnist_bigan_config()
    plan = cfg.enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev, c_in=7, std=None)
    flat = trunk_weights(params)
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(conv_ops))]
    feats = tensor(rng.normal(0, 1, (b, 128, 128, 7)))
    plain = fused_encoder_reference(feats, pairs, conv_ops)
    out = fused_encoder_forward(params, feats, plan)
    torch.cuda.synchronize()
    trunk_tol = 1e-4 * max(1.0, plain.abs().max().item())
    trunk_err = (out - plain).abs().max().item()
    print(f"fused_encoder audio trunk: max|kernel - plain| = {trunk_err:.3e} (tol {trunk_tol:.3e})")
    check(out.shape == plain.shape == (b, cfg.latent_dim), f"audio trunk output shape {tuple(out.shape)}")
    check(trunk_err <= trunk_tol, "fused_encoder disagrees with its plain version on the audio trunk")
    del plain, out

    # ----------------------------------------------------- A3. the path
    g = torch.Generator().manual_seed(args.seed)
    graph = build_audio_mnist_graph()
    scm = AudioMNISTAttributeSCM(graph, *graph.init(g, dev))
    clf = CNNClassifier(audio_mnist_classifier_config(10), dev, g).eval()
    engine = CounterfactualEngine(BiGAN(cfg, dev, g), scm, AttributeScaler.fit(AUDIO_MNIST_SPEC, {}), dev)
    xd = tensor(rng.uniform(-1, 1, (b, 128, 128, 1)))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, b)), a.n_categories)
             .float().to(dev) for a in AUDIO_MNIST_SPEC}

    fused_encoder_forward.launches = 0
    fused_dense_lrelu.launches = 0
    score = cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", args.mc_rounds)
    torch.cuda.synchronize()
    launches = {"fused_encoder": fused_encoder_forward.launches, "fused_dense": fused_dense_lrelu.launches}
    print(f"audio path: cf_effectiveness_score = {score:.4f}; launches {launches}")
    check(np.isfinite(score) and 0.0 <= score <= 1.0, f"score {score}")
    for kname, count in launches.items():
        check(count > 0, f"the AudioMNIST path did not reach the {kname} kernel")

    scm_d = engine.scm
    with torch.no_grad():
        obs = engine._to_graph_obs(attrs)
        new = resample_excluding(scm_d.graph, scm_d.params, scm_d.state, g, "digit", obs)
        x_cf, cf_attrs = engine.counterfactual(xd, attrs, {"digit": new}, g)
        logits = clf(x_cf)
        layers.fused_dense_lrelu = fused_dense_reference
        try:
            logits_plain = clf(x_cf)
        finally:
            layers.fused_dense_lrelu = fused_dense_lrelu
    torch.cuda.synchronize()
    check(x_cf.shape == (b, 128, 128, 1), f"x_cf shape {tuple(x_cf.shape)}")
    check(torch.isfinite(x_cf).all(), "non-finite x_cf")
    check(x_cf.abs().max().item() <= 1.0, "x_cf outside [-1, 1]")
    check(torch.equal(cf_attrs["digit"].argmax(-1), new), "the counterfactual digit is not the new class")
    check(bool((new != obs["digit"]).all()), "the resampled digit equals the observed one in some row")
    for a in AUDIO_MNIST_SPEC:
        if a.name != "digit":
            check(torch.equal(cf_attrs[a.name], attrs[a.name]), f"{a.name} changed under do(digit)")
    check(torch.isfinite(logits).all() and logits.shape == (b, 10), "classifier logits")
    logit_tol = 1e-4 * max(1.0, logits_plain.abs().max().item())
    logit_err = (logits - logits_plain).abs().max().item()
    print(f"classifier logits: max|kernel head - plain head| = {logit_err:.3e} (tol {logit_tol:.3e})")
    check(logit_err <= logit_tol, "the classifier's fused head disagrees with its plain version")

    # ------------------------------------------------------ A4. times
    x, w, bias = dense_in[head]
    with torch.no_grad():
        dense_ms = time_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2), reps=200, warmup=10)
        dense_plain_ms = time_ms(lambda: fused_dense_reference(x, w, bias, 0.2), reps=200, warmup=10)
        dense_lib_ms = time_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2), reps=200, warmup=10)
        dense_device = {
            "device_ms": device_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2)),
            "plain_device_ms": device_ms(lambda: fused_dense_reference(x, w, bias, 0.2)),
            "library_device_ms": device_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2)),
        }
        trunk_ms = time_ms(lambda: fused_encoder_forward(params, feats, plan), reps=10, warmup=2)
        trunk_plain_ms = time_ms(lambda: fused_encoder_reference(feats, pairs, conv_ops), reps=3, warmup=1)
        trunk_lib_ms = time_ms(lambda: library_stack(feats, pairs, conv_ops), reps=10, warmup=2)
        lib_err = (library_stack(feats, pairs, conv_ops)
                   - fused_encoder_reference(feats, pairs, conv_ops)).abs().max().item()
        check(lib_err <= trunk_tol, f"library stack disagrees with the plain audio trunk ({lib_err:.3e})")
        score_ms = time_ms(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", args.mc_rounds),
                           reps=3, warmup=1)
        a_cf = {**attrs, "digit": cf_attrs["digit"]}
        z = engine.bigan.encoder(xd, attrs)
        stages = {
            "scm_and_resample": time_ms(lambda: engine._to_model_attrs(scm_d.graph.sample_cf(
                scm_d.params, scm_d.state, g, obs, {"digit": resample_excluding(
                    scm_d.graph, scm_d.params, scm_d.state, g, "digit", obs)})), reps=10),
            "encoder": time_ms(lambda: engine.bigan.encoder(xd, attrs), reps=5),
            "generator": time_ms(lambda: engine.bigan.generator(z, a_cf), reps=5),
            "classifier": time_ms(lambda: clf(x_cf), reps=5),
        }
    if args.profile:
        t0 = time.perf_counter()
        cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1)
        print(f"one scoring round: {(time.perf_counter() - t0) * 1e3:.3f} ms on the host clock")
        profile_path(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1),
                      "chip_smoke_profile_audio.txt")
    gflop = {
        "encoder": plan_flops(cfg.enc_plan, (128, 128, 7)) / 1e9,
        "generator": plan_flops(cfg.gen_plan, (cfg.latent_dim + 6 * cfg.embed_dim,)) / 1e9,
        "classifier": plan_flops(clf.cfg.plan, (128, 128, 1)) / 1e9,
    }

    tflops, tbytes = trunk_cost(tuple(feats.shape), pairs, conv_ops)
    dflops, dbytes = dense_cost(*head)
    rows = [
        row("fused_encoder:audio_mnist", "imagecfgen_torch/csrc/fused_encoder.cu",
            "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches["fused_encoder"], trunk_err,
            trunk_ms, trunk_plain_ms, trunk_lib_ms, tflops, tbytes, peak, card, batch=b),
        row("fused_dense", "imagecfgen_torch/csrc/fused_dense.cu",
            "imagecfgen_tpu/ops/pallas/fused_dense.py:57", launches["fused_dense"],
            max(dense_errs.values()), dense_ms, dense_plain_ms, dense_lib_ms, dflops, dbytes, peak, card,
            shape=list(head), **dense_device),
    ]
    line = {
        "path": f"audio_mnist cf_effectiveness_score(digit, mc_rounds={args.mc_rounds})",
        "batch": b,
        "score": score,
        "ms_per_score": score_ms,
        "counterfactuals_per_s": b * args.mc_rounds / (score_ms / 1e3),
        "stages_ms": stages,
        "gflop_per_sample": gflop,
        "stage_tflops": {k: v * b / stages[k] for k, v in gflop.items()},
        "card": card,
    }
    return rows, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--audio-batch", type=int, default=128,
                    help="batch of the AudioMNIST scoring path")
    ap.add_argument("--mc-rounds", type=int, default=4,
                    help="rounds of the AudioMNIST CF-effectiveness score")
    ap.add_argument("--profile", action="store_true",
                    help="also write torch.profiler tables of one MNIST counterfactual "
                         f"batch and one AudioMNIST scoring round to {PROFILE_DIR}/")
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
    _build.load_libraries("fused_encoder", "fused_dense")
    print(f"build: fused_encoder, fused_dense in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in _build.BUILD_LOG.items():
        print(f"nvcc {lib}: {secs:.2f} s")
        for line in kernel_lines(log):
            print(line)

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
    peak = peaks(name)
    kernels = [row("fused_encoder", "imagecfgen_torch/csrc/fused_encoder.cu",
                   "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches, errs[0],
                   kernel_ms, plain_ms, library_ms, flops, nbytes, peak, card, batch=b)]
    engine_line = {
        "engine": "counterfactual do(thickness+2)",
        "batch": b,
        "ms_per_batch": cf_ms,
        "images_per_s": b / (cf_ms / 1e3),
        "stages_ms": stages_ms,
        "card": card,
    }
    if args.profile:
        profile_path(lambda: engine.counterfactual(xd, attrs, do), "chip_smoke_profile.txt")

    # ------------------------------------------- A2-A4. the AudioMNIST path
    audio_rows, score_line = audio_phases(args, dev, card, peak)
    kernels += audio_rows
    print(json.dumps(engine_line))
    print(json.dumps(score_line))
    print(json.dumps({"kernels": kernels}))

    # ---------------------------------------------------------- 5. the end
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
