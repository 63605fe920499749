"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--seed 0] [--batch 2048] [--audio-batch 128]
                          [--mc-rounds 4] [--profile]

Every kernel check, path and time below is made twice: in float32 (inside
the two kernels that means 3xTF32 on the tensor cores, elsewhere full
float32: TF32 is switched off for cuDNN and cuBLAS) and with
``compute_dtype=torch.bfloat16``. Gates: max |kernel - plain| <=
1e-4 * max(1, max |plain|) in float32, <= 2**-6 * max(1, max |plain|) in
bfloat16 (two bf16 ulps at the top of the range; kernel and plain version
take the same bf16 values, accumulate in float32 and round once, so the order
of the sum is the only difference).

Phases (any failure ends the run with a non-zero exit):

1. set-up: the card's name and power limit, TF32 off, build of the CUDA
   kernels from ``imagecfgen_torch/csrc`` (one ``nvcc`` each, in parallel);
2. each kernel against its plain PyTorch version at the MNIST path's shapes
   (the full-width ``mnist_bigan_config()`` encoder trunk at ``--batch``,
   its launch plan printed), and again after one weight was scaled in place
   (the packed weights must follow);
3. the MNIST path end to end: ``CounterfactualEngine.counterfactual`` with
   ``do(thickness + 2)`` and ``reconstruct`` at full width, with the kernels'
   launch counts read around that run only;
4. times with CUDA events: each kernel, its plain version, the PyTorch
   library stack computing the same function, and the engine's rate;

and for the AudioMNIST scoring path (``--audio-batch``):

A2. ``fused_dense`` against its plain version at the classifier head's
    shape (``--audio-batch``, 4096, 1024) and at ragged shapes (one with a
    row stride that is no multiple of 16 bytes), and
    ``fused_encoder`` on the full-width ``audio_mnist_bigan_config()``
    encoder trunk (5x5 kernels, 7 input channels, 128^2 input);
A3. the path end to end: ``cf_effectiveness_score`` (target ``digit``,
    ``--mc-rounds`` rounds) over the full-width AudioMNIST BiGAN, attribute
    SCM and classifier, with both kernels' launch counts read around that
    run only; then one counterfactual with a resampled digit, checked
    attribute by attribute, and the classifier against its plain head;
A4. times: each kernel at the path's shapes beside its plain version, the
    library call and its bound, and the score's rate with its stages.

and for the training paths, all in float32 (100 steps a timed epoch):

T1. GAN training on MNIST at full width: ``GANTrainer`` on
    ``mnist_bigan_config()``, batch 64, ``d_updates_per_g_update=3``, a
    device-resident synthetic set, one warm-up ``fit_epoch`` and one timed:
    finite metrics, every parameter of E, G and D changed and left with a
    gradient, D's running statistics moved, Adam's D count twice the step
    count, one ``fused_encoder`` launch a step; steps/s, images/s;
T6. checkpoint: T1's state saved, loaded into a fresh trainer, one more step
    from each on the same batch, each drawing its noise from its own
    (restored) generator, compared bit for bit;
T1b. the time of each phase of a step (E+G update, recompute, D real, D fake);
T1c. ``fused_encoder`` against its plain version at the shape the recompute
    phase gives it, (64, 28, 28, 5), whose launch plan differs from the
    serving batch's: on the trainer's own weights and attribute channels, and
    on fan-in-scaled weights, whose O(1) outputs make the gate bite;
T2. the gradient routes: the encoder's gradients through its
    ``PlanSequential`` against the plain im2col version's, ``fused_dense``'s
    ``dx``, ``dw``, ``db`` at (128, 4096, 1024) against autograd through its
    plain version (float32 gate; the plain side takes each LeakyReLU on the
    side of its kink that the checked route's activation lies on, since a
    value within rounding of zero can differ in sign between two routes and
    the gradient jumps there; such values may number at most 4 or 1e-5 of all and
    each must lie within 1e-5 * max(1, max |input|) of zero in both routes),
    and ``fused_encoder_forward`` raising when asked for a gradient on the
    card;
T3. classifier training on AudioMNIST at full width: ``SupervisedTrainer`` on
    ``audio_mnist_classifier_config(10)``, batch 128, 20 steps of ``ce``: the
    loss on a fixed batch falls, one ``fused_dense`` launch a step, the head's
    weight changed; steps/s;
T4. GAN training on AudioMNIST at full width, batch 32, 5 steps (``init_std``
    0.01, the value the JAX package's audio battery trains with: at the
    config's 0.001 the first steps' gradients are too small to tell a moved
    parameter from a still one), then ``fused_encoder`` against its plain
    version at that path's shape, (32, 128, 128, 7), as in T1c;
T5. both attribute SCMs' MLE ``fit`` on a few thousand synthetic rows: the
    NLL falls, and ``sample_cf`` on the fitted SCM passes the serving checks.

The ``kernels`` line lists every kernel row (``launches``: the serving path's;
``train_launches`` over ``train_steps``: the training path's); the last line
of output is
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
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# where --profile writes its tables
PROFILE_DIR = "chiprun_out"

# dense tensor-core rates (TFLOP/s: TF32, bf16) and memory rates (TB/s) from
# NVIDIA's data sheets, by a substring of torch.cuda.get_device_name()
PEAKS = (
    ("H100 PCIe", 378.0, 756.0, 2.0),
    ("H100 NVL", 417.0, 835.0, 3.9),
    ("H200", 495.0, 989.0, 4.8),
    ("H100", 495.0, 989.0, 3.35),  # SXM: "NVIDIA H100 80GB HBM3"
)
TRAIN_STEPS = 100  # steps of each MNIST GAN-training epoch (warm-up and timed)
F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
TAG = {F32: "f32", BF16: "bf16"}
# max |kernel - plain| <= GATE * max(1, max |plain|)
GATE = {F32: 1e-4, BF16: 2.0 ** -6}


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
    """{dtype: FLOP/s of the unit the kernels use} and bytes/s. float32
    tensors take three TF32 products per product, so a third of that rate."""
    for key, tf32, bf16, tbs in PEAKS:
        if key in name:
            return {F32: tf32 * 1e12 / 3, BF16: bf16 * 1e12}, tbs * 1e12
    raise RuntimeError(f"no peak rates known for {name!r}")


def agree(what: str, out, plain, dtype) -> float:
    """Hold a kernel's output against its plain version; returns the error."""
    check(out.shape == plain.shape and out.dtype == plain.dtype == dtype,
          f"{what}: {tuple(out.shape)} {out.dtype} against {tuple(plain.shape)} {plain.dtype}")
    out, plain = out.float(), plain.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    tol = GATE[dtype] * max(1.0, plain.abs().max().item())
    err = (out - plain).abs().max().item()
    print(f"{what} [{TAG[dtype]}]: max|kernel - plain| = {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"{what} [{TAG[dtype]}] disagrees with its plain version")
    return err


def cast_pairs(params, dtype):
    """Trunk parameters in ``dtype`` and as (kernel, bias) pairs."""
    from imagecfgen_torch.ops.fused_encoder import trunk_weights

    cast = {k: v.to(dtype) for k, v in params.items()}
    flat = trunk_weights(cast)
    return cast, [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def check_trunk(name: str, params, feats, plan, dtype, splits=(0,)):
    """The trunk kernel against its plain version at ``feats``' shape, its
    launch plan printed, and once more after a weight changed in place.
    Returns (error, cast params, pairs, feats in dtype, plain output)."""
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_launch_plan,
    )
    from imagecfgen_torch.ops.tensor_core import sm_count

    conv_ops = plan_conv_ops(plan)
    cast, pairs = cast_pairs(params, dtype)
    x = feats.to(dtype)
    for i, lp in enumerate(trunk_launch_plan(tuple(x.shape), [tuple(w.shape) for w, _ in pairs],
                                             conv_ops, dtype, sm_count(x.device))):
        print(f"launch plan {name} [{TAG[dtype]}] layer {i + 1}: {lp.describe()}")
    plain = fused_encoder_reference(x, pairs, conv_ops)
    errs = []
    for split in splits:
        out = fused_encoder_forward(cast, x, plan, split=split)
        torch.cuda.synchronize()
        errs.append(agree(f"fused_encoder {name} split={split}", out, plain, dtype))
    # stale weights: the packed copy must follow an in-place update
    last = f"conv_{len(pairs) - 1}_kernel"
    saved = cast[last].clone()
    cast[last].mul_(1.5)
    out = fused_encoder_forward(cast, x, plan)
    torch.cuda.synchronize()
    agree(f"fused_encoder {name} after an in-place weight update", out,
          fused_encoder_reference(x, pairs, conv_ops), dtype)
    check((out.float() - plain.float()).abs().max().item() > 0, "the weight update changed nothing")
    cast[last].copy_(saved)
    return errs[0], cast, pairs, x, plain


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


def trunk_cost(feats_shape, pairs, conv_ops, esize: int = 4):
    """(FLOPs, bytes) the trunk must do and move: each input read once, each
    output written once, ``esize`` bytes an element."""
    from imagecfgen_torch.ops.conv import conv_out_size

    b, h, w, c = feats_shape
    flops, nbytes = 0, esize * b * h * w * c
    for (stride, pad, _), (wt, bias) in zip(conv_ops, pairs):
        co, ci, k, _ = wt.shape
        h, w = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad)
        flops += 2 * b * h * w * co * ci * k * k
        nbytes += esize * (wt.numel() + bias.numel())
    return flops, nbytes + esize * b * h * w * co


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
        if "__nv_bfloat16" in mangled:
            targs.insert(0, "bf16")
        elif re.search(r"conv_\w+?If", mangled):
            targs.insert(0, "f32")
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


def row(name, dtype, source, replaces, launches, err, kernel_ms, plain_ms, library_ms,
        flops, nbytes, peak, card, **extra):
    """One entry of the ``kernels`` line; the bound is the larger of the
    operations over the rate of the unit the kernel uses in ``dtype`` (a
    third of the TF32 rate for float32, the bf16 rate) and the bytes over
    the memory rate."""
    from imagecfgen_torch.ops.tensor_core import INSTRUCTION

    t_ops, t_bytes = flops / peak[0][dtype] * 1e3, nbytes / peak[1] * 1e3
    return {
        "name": name if dtype == F32 else f"{name}:bf16", "dtype": TAG[dtype],
        "instruction": INSTRUCTION, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, **extra, "flops": flops, "bytes": nbytes, "card": card,
    }


def dense_cost(m: int, k: int, n: int, esize: int = 4):
    """(FLOPs, bytes) of ``lrelu(x @ w.T + b)``: each input read once, the
    output written once, ``esize`` bytes an element."""
    return 2 * m * n * k, esize * (m * k + n * k + n + m * n)


def layer_times(name: str, pairs, conv_ops, feats, dtype):
    """Each layer of a trunk alone (``--profile``): the kernel on that
    layer's input beside one ``F.conv2d`` (+ ``F.leaky_relu``), in ms and in
    TFLOP/s of the layer's 2 * M * N * K operations."""
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    x, out = feats, []
    with torch.no_grad():
        for i, ((stride, pad, slope), (w, b)) in enumerate(zip(conv_ops, pairs)):
            one = {"conv_0_kernel": w, "conv_0_bias": b}
            plan = (("conv", w.shape[0], w.shape[2], stride, pad),)
            plan += (("lrelu", slope),) if slope is not None else ()
            xi = x
            ms = time_ms(lambda: fused_encoder_forward(one, xi, plan), reps=10, warmup=2)
            lib_ms = time_ms(lambda: library_stack(xi, [(w, b)], [(stride, pad, slope)]), reps=10, warmup=2)
            y = fused_encoder_forward(one, xi, plan)
            flops = 2 * y.numel() * w[0].numel()
            out.append({"layer": i + 1, "ms": ms, "tflops": flops / ms / 1e9, "library_ms": lib_ms})
            oh = (x.shape[1] + 2 * pad - w.shape[2]) // stride + 1
            ow = (x.shape[2] + 2 * pad - w.shape[2]) // stride + 1
            x = y.reshape(x.shape[0], oh, ow, w.shape[0])
    print(json.dumps({"layers": name, "dtype": TAG[dtype], "times": out}))


def seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def audio_phases(args, dev, card, peak):
    """Phases A2-A4: the AudioMNIST scoring path in both types. Returns
    (kernel rows, score lines)."""
    import dataclasses

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
    )
    from imagecfgen_torch.ops.tensor_core import plan_gemm, sm_count
    from imagecfgen_torch.scm.audio_mnist import AudioMNISTAttributeSCM, build_audio_mnist_graph

    b = args.audio_batch
    rng = np.random.default_rng(args.seed + 2)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # ------------------------------- A2. kernels against their plain versions
    head = (b, 4096, 1024)
    dense_in = {}
    dense_errs = {dtype: [] for dtype in DTYPES}
    for m, k, n in (head, (100, 300, 200), (100, 3000, 200), (100, 301, 200)):
        x32 = tensor(rng.normal(0, 1, (m, k)))
        w32 = tensor(rng.normal(0, 1 / np.sqrt(k), (n, k)))
        bias32 = tensor(rng.normal(0, 0.5, n))
        for dtype in DTYPES:
            x, w, bias = x32.to(dtype), w32.to(dtype), bias32.to(dtype)
            print(f"launch plan fused_dense {m}x{k}x{n} [{TAG[dtype]}]: "
                  f"{plan_gemm(m, n, k, k, dtype, sm_count(dev)).describe()}")
            out = fused_dense_lrelu(x, w, bias, 0.2)
            torch.cuda.synchronize()
            dense_errs[dtype].append(agree(f"fused_dense {m}x{k}x{n}", out,
                                           fused_dense_reference(x, w, bias, 0.2), dtype))
            dense_in[(m, k, n), dtype] = (x, w, bias)

    plan = audio_mnist_bigan_config().enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev, c_in=7, std=None)
    feats = tensor(rng.normal(0, 1, (b, 128, 128, 7)))
    trunk = {dtype: check_trunk("audio trunk", params, feats, plan, dtype) for dtype in DTYPES}

    # ----------------------------------------------------- A3. the path
    graph = build_audio_mnist_graph()
    scm = AudioMNISTAttributeSCM(graph, *graph.init(seeded(args.seed), dev))
    xd = tensor(rng.uniform(-1, 1, (b, 128, 128, 1)))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, b)), a.n_categories)
             .float().to(dev) for a in AUDIO_MNIST_SPEC}
    rows, lines, x_cfs = [], [], {}
    for dtype in DTYPES:
        # the same float32 parameters in both types: one seed
        cfg = audio_mnist_bigan_config(compute_dtype=dtype)
        clf_cfg = dataclasses.replace(audio_mnist_classifier_config(10), compute_dtype=dtype)
        clf = CNNClassifier(clf_cfg, dev, seeded(args.seed + 3)).eval()
        engine = CounterfactualEngine(BiGAN(cfg, dev, seeded(args.seed + 4)), scm,
                                      AttributeScaler.fit(AUDIO_MNIST_SPEC, {}), dev)

        fused_encoder_forward.launches = 0
        fused_dense_lrelu.launches = 0
        score = cf_effectiveness_score(engine, clf, xd, attrs, seeded(args.seed + 5), "digit",
                                       args.mc_rounds)
        torch.cuda.synchronize()
        launches = {"fused_encoder": fused_encoder_forward.launches,
                    "fused_dense": fused_dense_lrelu.launches}
        print(f"audio path [{TAG[dtype]}]: cf_effectiveness_score = {score:.4f}; launches {launches}")
        check(np.isfinite(score) and 0.0 <= score <= 1.0, f"score {score}")
        for kname, count in launches.items():
            check(count > 0, f"the AudioMNIST path [{TAG[dtype]}] did not reach the {kname} kernel")

        with torch.no_grad():
            g = seeded(args.seed + 6)
            obs = engine._to_graph_obs(attrs)
            new = resample_excluding(scm.graph, scm.params, scm.state, g, "digit", obs)
            x_cf, cf_attrs = engine.counterfactual(xd, attrs, {"digit": new}, g)
            logits = clf(x_cf)
            layers.fused_dense_lrelu = fused_dense_reference
            try:
                logits_plain = clf(x_cf)
            finally:
                layers.fused_dense_lrelu = fused_dense_lrelu
        torch.cuda.synchronize()
        x_cfs[dtype] = x_cf
        check(x_cf.shape == (b, 128, 128, 1) and x_cf.dtype == F32, f"x_cf {tuple(x_cf.shape)} {x_cf.dtype}")
        check(torch.isfinite(x_cf).all(), "non-finite x_cf")
        check(x_cf.abs().max().item() <= 1.0, "x_cf outside [-1, 1]")
        check(torch.equal(cf_attrs["digit"].argmax(-1), new), "the counterfactual digit is not the new class")
        check(bool((new != obs["digit"]).all()), "the resampled digit equals the observed one in some row")
        for a in AUDIO_MNIST_SPEC:
            if a.name != "digit":
                check(torch.equal(cf_attrs[a.name], attrs[a.name]), f"{a.name} changed under do(digit)")
        check(torch.isfinite(logits).all() and logits.shape == (b, 10) and logits.dtype == F32,
              "classifier logits")
        logit_tol = GATE[dtype] * max(1.0, logits_plain.abs().max().item())
        logit_err = (logits - logits_plain).abs().max().item()
        print(f"classifier logits [{TAG[dtype]}]: max|kernel head - plain head| = {logit_err:.3e} "
              f"(tol {logit_tol:.3e})")
        check(logit_err <= logit_tol, "the classifier's fused head disagrees with its plain version")

        # -------------------------------------------------- A4. times
        x, w, bias = dense_in[head, dtype]
        trunk_err, cast, pairs, tfeats, _ = trunk[dtype]
        with torch.no_grad():
            dense_ms = time_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2), reps=200, warmup=10)
            dense_plain_ms = time_ms(lambda: fused_dense_reference(x, w, bias, 0.2), reps=100, warmup=5)
            dense_lib_ms = time_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2), reps=200, warmup=10)
            dense_device = {
                "device_ms": device_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2)),
                "plain_device_ms": device_ms(lambda: fused_dense_reference(x, w, bias, 0.2)),
                "library_device_ms": device_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2)),
            }
            trunk_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=10, warmup=2)
            trunk_plain_ms = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=2, warmup=1)
            trunk_lib_ms = time_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=10, warmup=2)
            trunk_device_ms = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=5)
            lib = library_stack(tfeats, pairs, conv_ops).float()
            plain = fused_encoder_reference(tfeats, pairs, conv_ops).float()
            lib_err = (lib - plain).abs().max().item()
            # cuDNN's bf16 stack rounds at other places than the fused trunk: printed, gated in f32 only
            print(f"library stack audio trunk [{TAG[dtype]}]: max|library - plain| = {lib_err:.3e}")
            check(dtype != F32 or lib_err <= GATE[F32] * max(1.0, plain.abs().max().item()),
                  f"library stack disagrees with the plain audio trunk ({lib_err:.3e})")
            del lib, plain
            score_ms = time_ms(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit",
                                                              args.mc_rounds), reps=3, warmup=1)
            a_cf = {**attrs, "digit": cf_attrs["digit"]}
            z = engine.bigan.encoder(xd, attrs)
            stages = {
                "scm_and_resample": time_ms(lambda: engine._to_model_attrs(scm.graph.sample_cf(
                    scm.params, scm.state, g, obs, {"digit": resample_excluding(
                        scm.graph, scm.params, scm.state, g, "digit", obs)})), reps=10),
                "encoder": time_ms(lambda: engine.bigan.encoder(xd, attrs), reps=5),
                "generator": time_ms(lambda: engine.bigan.generator(z, a_cf), reps=5),
                "classifier": time_ms(lambda: clf(x_cf), reps=5),
            }
        if args.profile:
            layer_times("audio trunk", pairs, conv_ops, tfeats, dtype)
            t0 = time.perf_counter()
            cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1)
            print(f"one scoring round [{TAG[dtype]}]: {(time.perf_counter() - t0) * 1e3:.3f} ms on the host clock")
            profile_path(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1),
                         f"chip_smoke_profile_audio_{TAG[dtype]}.txt")
        gflop = {
            "encoder": plan_flops(cfg.enc_plan, (128, 128, 7)) / 1e9,
            "generator": plan_flops(cfg.gen_plan, (cfg.latent_dim + 6 * cfg.embed_dim,)) / 1e9,
            "classifier": plan_flops(clf.cfg.plan, (128, 128, 1)) / 1e9,
        }
        esize = tfeats.element_size()
        tflops, tbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops, esize)
        dflops, dbytes = dense_cost(*head, esize)
        rows += [
            row("fused_encoder:audio_mnist", dtype, "imagecfgen_torch/csrc/fused_encoder.cu",
                "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches["fused_encoder"], trunk_err,
                trunk_ms, trunk_plain_ms, trunk_lib_ms, tflops, tbytes, peak, card, batch=b,
                device_ms=trunk_device_ms),
            row("fused_dense", dtype, "imagecfgen_torch/csrc/fused_dense.cu",
                "imagecfgen_tpu/ops/pallas/fused_dense.py:57", launches["fused_dense"],
                max(dense_errs[dtype]), dense_ms, dense_plain_ms, dense_lib_ms, dflops, dbytes, peak,
                card, shape=list(head), **dense_device),
        ]
        lines.append({
            "path": f"audio_mnist cf_effectiveness_score(digit, mc_rounds={args.mc_rounds})",
            "compute_dtype": TAG[dtype],
            "batch": b,
            "score": score,
            "ms_per_score": score_ms,
            "counterfactuals_per_s": b * args.mc_rounds / (score_ms / 1e3),
            "stages_ms": stages,
            "gflop_per_sample": gflop,
            "stage_tflops": {k: v * b / stages[k] for k, v in gflop.items()},
            "card": card,
        })
        del engine, clf
    diff = (x_cfs[BF16] - x_cfs[F32]).abs().max().item()
    print(f"audio path: max|x_cf(bf16) - x_cf(f32)| = {diff:.3e} (printed, not gated)")
    return rows, lines


def changed(before, module, what: str) -> None:
    """Every parameter of ``module`` differs from its clone in ``before``
    and holds a gradient."""
    for n, p in module.named_parameters():
        check(p.grad is not None, f"{what}: {n} ended a step with grad None")
        check(not torch.equal(p.detach(), before[n]), f"{what}: {n} did not change")


def grads_agree(what: str, got, plain) -> float:
    """Gradients against the plain route's, under the float32 gate; every
    gradient outside it is printed before the run fails."""
    worst, bad = 0.0, []
    for name in plain:
        g, p = got[name], plain[name]
        check(g is not None and g.shape == p.shape, f"{what}: gradient of {name} missing")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite gradient of {name}")
        tol = GATE[F32] * max(1.0, p.abs().max().item())
        err = (g - p).abs().max().item()
        if err > tol:
            bad.append(name)
            print(f"{what}: gradient of {name} off by {err:.3e} (tol {tol:.3e}, max|plain| "
                  f"{p.abs().max().item():.3e})")
        worst = max(worst, err / tol)
    check(not bad, f"{what}: gradients of {bad} outside the gate")
    print(f"{what}: {len(plain)} gradients within the gate (worst at {worst:.1%} of it)")
    return worst


def near_kink(what: str, a, b, total_gate: float = 1e-5) -> int:
    """The LeakyReLU inputs that lie on different sides of zero in two routes
    (``a``, ``b``: lists of pre-activations): there may be at most 4 or
    ``total_gate`` of all of them, each within float32 rounding of zero,
    ``1e-5 * max(1, max|input|)``, in both routes. Returns their number."""
    flips, total = 0, sum(t.numel() for t in a)
    most = max(4, int(total_gate * total))
    for i, (u, v) in enumerate(zip(a, b)):
        flipped = (u >= 0) != (v >= 0)
        n = int(flipped.sum())
        if n:
            near = 1e-5 * max(1.0, u.abs().max().item())
            far = max(u[flipped].abs().max().item(), v[flipped].abs().max().item())
            check(far <= near, f"{what}: a LeakyReLU input of layer {i + 1} changes sign between the "
                               f"routes at |value| {far:.3e}, beyond rounding ({near:.3e})")
        flips += n
    print(f"{what}: {flips} of {total} LeakyReLU inputs lie on different sides of zero in the two "
          f"routes (at most {most} may, each within rounding of zero)")
    check(flips <= most, f"{what}: {flips} LeakyReLU inputs change sides between the routes")
    return flips


def trunk_at_training_shape(name: str, encoder, x, attrs, plan, seed: int, dev):
    """The trunk kernel against its plain version at the shape a trainer's
    recompute phase gives it (``plan_gemm`` picks tiles and splits from the
    batch): on the trainer's own encoder weights and attribute channels, and
    on fan-in-scaled weights and N(0, 1) features of that shape, whose O(1)
    outputs make the float32 gate bite."""
    with torch.no_grad():
        feats = encoder.attr_channels(x, attrs)
        own = {n: p.detach() for n, p in encoder.trunk.named_parameters()}
        err, _, _, _, plain = check_trunk(f"{name}, the trainer's weights", own, feats, plan, F32)
        top = plain.abs().max().item()
        print(f"fused_encoder {name}, the trainer's weights: max|plain| = {top:.3e}, "
              f"relative error {err / top:.3e} (printed, not gated)")
        rng = np.random.default_rng(seed)
        probe = torch.from_numpy(rng.normal(0, 1, tuple(feats.shape)).astype(np.float32)).to(dev)
        check_trunk(f"{name}, fan-in weights", trunk_params(plan, seed, dev, c_in=feats.shape[-1], std=None),
                    probe, plan, F32)


def gan_data(cfg, n: int, rng, dev):
    """A synthetic device-resident set for ``cfg``: U(-1, 1) images, uniform
    one-hot categorical attributes, U(-1, 1) continuous ones (scaled)."""
    h, w = cfg.image_size
    x = torch.from_numpy(rng.uniform(-1, 1, (n, h, w, cfg.image_channels)).astype(np.float32))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, n)),
                               a.n_categories).float() for a in cfg.attr_spec.categorical}
    attrs.update({a.name: torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
                  for a in cfg.attr_spec.continuous})
    return x.to(dev), {k: v.to(dev) for k, v in attrs.items()}


def training_phases(args, dev, card):
    """Phases T1-T6. Returns ({kernel row name: (launches, steps)}, lines)."""
    import dataclasses

    from imagecfgen_torch.core.checkpoint import load_meta, load_train_state, save_train_state
    from imagecfgen_torch.ops.conv import conv2d, conv_out_size
    from imagecfgen_torch.models.bigan import (
        BiGAN,
        Encoder,
        audio_mnist_bigan_config,
        mnist_bigan_config,
    )
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_weights,
    )
    from imagecfgen_torch.scm.audio_mnist import CARDINALITIES, AudioMNISTAttributeSCM
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM
    from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer
    from imagecfgen_torch.train.gan_trainer import METRICS, GANTrainConfig, GANTrainer

    rng = np.random.default_rng(args.seed + 20)
    lines, train_launches = [], {}

    # ------------------------------------------ T1. GAN training, MNIST
    steps, bsz = TRAIN_STEPS, 64
    cfg = mnist_bigan_config()
    tcfg = GANTrainConfig(batch_size=bsz, d_updates_per_g_update=3)
    tr = GANTrainer(BiGAN(cfg, dev, seeded(args.seed + 21)), tcfg, seed=args.seed + 22)
    data = tr.upload_dataset(*gan_data(cfg, steps * bsz, rng, dev))
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in tr.model.discriminator.named_buffers()}
    check(len(stats0) == 8, f"D has {len(stats0)} batch-norm buffers, not 8")
    fused_encoder_forward.launches = 0
    warm = tr.fit_epoch(data)
    check(fused_encoder_forward.launches == steps, "warm-up epoch: one fused_encoder launch a step")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fused_encoder_forward.launches = 0
    start.record()
    metrics = tr.fit_epoch(data)
    end.record()
    torch.cuda.synchronize()
    epoch_ms = start.elapsed_time(end)
    launches = fused_encoder_forward.launches
    train_launches["fused_encoder"] = (launches, steps)
    print(f"T1 GAN training MNIST: {steps} steps in {epoch_ms:.1f} ms; fused_encoder launched "
          f"{launches} times; metrics {metrics}")
    for m in (warm, metrics):
        check(sorted(m) == sorted(METRICS) and all(np.isfinite(v) for v in m.values()), f"metrics {m}")
    check(launches == steps, f"{launches} fused_encoder launches in {steps} steps")
    check(tr.step == 2 * steps, f"step count {tr.step}")
    changed(before, tr.model, "T1")
    for n, b in tr.model.discriminator.named_buffers():
        check(not torch.equal(b, stats0[n]) and bool(torch.isfinite(b).all()),
              f"T1: D's running statistic {n} did not move")
    state = tr.state_dict()
    check(state["opt_d"]["count"] == 2 * tr.step, f"Adam's D count {state['opt_d']['count']}")
    check(state["opt_eg"]["count"] == -(-tr.step // 3), f"Adam's E+G count {state['opt_eg']['count']}")
    gan_line = {
        "trainer": "GANTrainer mnist_bigan_config()", "compute_dtype": "f32", "batch": bsz,
        "d_updates_per_g_update": 3, "steps": steps, "ms_per_step": epoch_ms / steps,
        "steps_per_s": steps / (epoch_ms / 1e3), "images_per_s": steps * bsz / (epoch_ms / 1e3),
        "fused_encoder_launches": launches, "metrics": metrics, "card": card,
    }

    # ------------------------------------------------ T6. checkpoint
    batch = {"image": data["image"][:bsz], "attrs": {k: v[:bsz] for k, v in data["attrs"].items()}}
    other = GANTrainer(BiGAN(cfg, dev, seeded(args.seed + 23)), tcfg, seed=args.seed + 24)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mnist-bigan-train.ckpt")
        t0 = time.perf_counter()
        save_train_state(path, state, meta={"kind": "bigan-train", "step": tr.step})
        size = os.path.getsize(path)
        check(load_meta(path) == {"kind": "bigan-train", "step": tr.step}, "checkpoint meta")
        loaded, _ = load_train_state(path)
        other.load_state_dict(loaded)
        print(f"T6 checkpoint: {size / 2**20:.1f} MiB saved and loaded in {time.perf_counter() - t0:.2f} s")
    del state, loaded
    check(other.step == tr.step, "restored step")
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:  # the same kernels in the same order on both sides
        ma, mb = tr.train_step(batch), other.train_step(batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn_det
    for k in METRICS:
        check(torch.equal(ma[k], mb[k]), f"T6: {k} differs after the resumed step")
    sa, sb = tr.state_dict(), other.state_dict()
    for part in ("E", "G", "D"):
        for n in sa[part]:
            check(torch.equal(sa[part][n], sb[part][n]), f"T6: {part}.{n} differs after the resumed step")
    for opt in ("opt_eg", "opt_d"):
        check(sa[opt]["count"] == sb[opt]["count"], f"T6: {opt} count")
        for moment in ("mu", "nu"):
            for n in sa[opt][moment]:
                check(torch.equal(sa[opt][moment][n], sb[opt][moment][n]), f"T6: {opt}.{moment}.{n} differs")
    check(torch.equal(sa["rng"], sb["rng"]), "T6: the generator's state differs")
    print("T6 checkpoint: the resumed trainer's next step is bit-identical (parameters, buffers, "
          "both Adam states, metrics, generator state)")
    del other, sa, sb

    # -------------------------------------------- T1b. the step by phase
    x, attrs = batch["image"], batch["attrs"]
    z, masks = tr.draw_noise(bsz)
    ex, gz = tr.recompute(x, attrs, z)
    gan_line["phases_ms"] = {
        "draw_noise": time_ms(lambda: tr.draw_noise(bsz)),
        "eg_update": time_ms(lambda: tr.eg_update(x, attrs, z, masks[0], masks[1])),
        "recompute": time_ms(lambda: tr.recompute(x, attrs, z)),
        "d_update_real": time_ms(lambda: tr.d_update(x, ex, attrs, 1, masks[2])),
        "d_update_fake": time_ms(lambda: tr.d_update(gz, z, attrs, 0, masks[3])),
    }
    lines.append(gan_line)
    if args.profile:
        profile_path(lambda: [tr.train_step(batch) for _ in range(5)], "chip_smoke_profile_train_f32.txt")

    # ---------------- T1c. the kernel at the shape the recompute gives it
    trunk_at_training_shape(f"MNIST trunk at batch {bsz}", tr.model.encoder, x, attrs, cfg.enc_plan,
                            args.seed + 35, dev)

    # ------------------------------------------ T2. the gradient routes
    enc = Encoder(cfg, dev, seeded(args.seed + 25))
    with torch.no_grad():  # O(1) activations, so that the gate means something
        for k, v in trunk_params(cfg.enc_plan, args.seed + 26, dev, std=None).items():
            getattr(enc.trunk, k).copy_(v)
    names = [n for n, _ in enc.trunk.named_parameters()]
    feats = torch.from_numpy(rng.normal(0, 1, (bsz, 28, 28, 5)).astype(np.float32)).to(dev)
    probe = torch.from_numpy(rng.normal(0, 1, (bsz, cfg.latent_dim)).astype(np.float32)).to(dev)

    conv_ops = plan_conv_ops(cfg.enc_plan)

    def route_grads(route):
        f = feats.clone().requires_grad_(True)
        params = dict(enc.trunk.named_parameters())
        out = route(params, f).reshape(bsz, -1)
        grads = torch.autograd.grad((out * probe).sum(), [f, *params.values()])
        return out.detach(), dict(zip(["features", *names], grads))

    def plain_layers(params, f, sides=None):
        """The plain im2col version layer by layer. ``sides``: the side of
        zero each LeakyReLU input is taken to lie on (the layer's own when
        None). Returns (output, the LeakyReLU inputs)."""
        flat, x, pre = trunk_weights(params), f, []
        for i, (stride, pad, slope) in enumerate(conv_ops):
            wt, bias = flat[2 * i], flat[2 * i + 1]
            oh = conv_out_size(x.shape[1], wt.shape[2], stride, pad)
            x = fused_encoder_reference(x, [(wt, bias)], [(stride, pad, None)]).reshape(bsz, oh, oh, -1)
            if slope is not None:
                pre.append(x)
                x = torch.where(x >= 0 if sides is None else sides[i], x, slope * x)
        return x, pre

    # The two routes round differently (1e-6), so an activation within that of
    # zero can lie on either side of a LeakyReLU's kink, where the gradient
    # jumps by the slope: the plain gradients are taken on the sides the
    # PlanSequential route's activations lie on, read from its own forward.
    # That is sound only while such activations are few and within rounding
    # of zero in both routes, which near_kink holds them to.
    with torch.no_grad():
        pre_plan, x_plan = [], feats
        for i, (stride, pad, slope) in enumerate(conv_ops):
            x_plan = conv2d(x_plan, getattr(enc.trunk, f"conv_{i}_kernel"), stride, pad) \
                + getattr(enc.trunk, f"conv_{i}_bias")
            if slope is not None:
                pre_plan.append(x_plan)
                x_plan = F.leaky_relu(x_plan, slope)
        near_kink("T2 encoder, PlanSequential against the plain im2col version", pre_plan,
                  plain_layers(dict(enc.trunk.named_parameters()), feats)[1])
    sides = [t >= 0 for t in pre_plan]

    fused_encoder_forward.launches = 0
    out_plan, g_plan = route_grads(lambda params, f: enc.trunk(f, train=True))
    out_plain, g_plain = route_grads(lambda params, f: plain_layers(params, f, sides)[0])
    check(torch.equal(out_plan.reshape(x_plan.shape), x_plan), "T2: the replayed forward is not the trunk's")
    agree("T2 encoder forward through its PlanSequential", out_plan, out_plain, F32)
    grads_agree("T2 encoder gradients, PlanSequential against the plain im2col version", g_plan, g_plain)
    z_grad = enc(x, attrs)
    check(z_grad.requires_grad and fused_encoder_forward.launches == 0,
          "T2: the encoder took the kernel while a gradient was recorded")
    with torch.no_grad():
        z_kernel = enc(x, attrs)
    check(fused_encoder_forward.launches == 1 and not z_kernel.requires_grad,
          "T2: the encoder did not take the kernel under no_grad")
    agree("T2 encoder, kernel route against differentiable route", z_kernel, z_grad.detach(), F32)
    try:
        fused_encoder_forward(dict(enc.trunk.named_parameters()), feats, cfg.enc_plan)
    except ValueError as e:
        print(f"T2 fused_encoder_forward refuses a gradient on the card: {e}")
    else:
        check(False, "T2: fused_encoder_forward returned a result while a gradient was asked of it")

    m, k, n = 128, 4096, 1024
    dx = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
    dw = torch.from_numpy(rng.normal(0, 1 / np.sqrt(k), (n, k)).astype(np.float32)).to(dev)
    db = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev)
    dprobe = torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(dev)

    def dense_grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (dx, dw, db)]
        out = fn(*leaves, 0.2)
        grads = torch.autograd.grad((out * dprobe).sum(), leaves)
        return out.detach(), dict(zip(("dx", "dw", "db"), grads))

    fused_dense_lrelu.launches = 0
    out, got = dense_grads(fused_dense_lrelu)
    check(fused_dense_lrelu.launches == 1, "T2: fused_dense_lrelu did not launch its kernel")
    # LeakyReLU keeps the sign, so the outputs' signs are the inputs'; an
    # output within rounding of zero has an input within 1 / slope of that
    near_kink("T2 fused_dense, kernel against plain version", [out],
              [fused_dense_reference(dx, dw, db, 0.2)])

    def plain_dense(x, w, b, slope):  # the plain version, on the kernel's sides of the kink
        z = x @ w.t() + b
        return torch.where(out >= 0, z, slope * z)

    grads_agree(f"T2 fused_dense backward at ({m}, {k}, {n}) against autograd through the plain version",
                got, dense_grads(plain_dense)[1])
    del enc, dx, dw, db

    # ------------------------------- T3. classifier training, AudioMNIST
    csteps, cb = 20, 128
    clf = CNNClassifier(audio_mnist_classifier_config(10), dev, seeded(args.seed + 27))
    ctr = SupervisedTrainer(clf, SupervisedTrainConfig(batch_size=cb, loss="ce"), seed=args.seed + 28)
    cx = torch.from_numpy(rng.uniform(-1, 1, (2 * cb, 128, 128, 1)).astype(np.float32)).to(dev)
    cy = F.one_hot(torch.from_numpy(rng.integers(0, 10, 2 * cb)), 10).float().to(dev)
    cbatches = [{"x": cx[i * cb:(i + 1) * cb], "y": cy[i * cb:(i + 1) * cb]} for i in range(2)]
    head0 = clf.trunk.dense_0_kernel.detach().clone()
    loss0 = ctr.compute_loss(ctr.predict(cbatches[0]["x"]), cbatches[0]["y"]).item()
    for i in range(2):  # warm-up: cuDNN picks its algorithms, the kernel library loads
        ctr.train_step(cbatches[i])
    fused_dense_lrelu.launches = 0
    torch.cuda.synchronize()
    start.record()
    losses = [ctr.train_step(cbatches[i % 2])["loss"] for i in range(csteps)]
    end.record()
    torch.cuda.synchronize()
    clf_ms = start.elapsed_time(end)
    launches = fused_dense_lrelu.launches
    train_launches["fused_dense"] = (launches, csteps)
    loss1 = ctr.compute_loss(ctr.predict(cbatches[0]["x"]), cbatches[0]["y"]).item()
    print(f"T3 classifier training AudioMNIST: {csteps} steps in {clf_ms:.1f} ms; fused_dense launched "
          f"{launches} times; loss on a fixed batch {loss0:.4f} -> {loss1:.4f}")
    check(all(np.isfinite(v) for v in torch.stack(losses).tolist()), "T3: non-finite loss")
    check(np.isfinite(loss1) and loss1 < loss0, f"T3: the loss did not fall ({loss0} -> {loss1})")
    check(launches == csteps, f"T3: {launches} fused_dense launches in {csteps} steps")
    check(not torch.equal(clf.trunk.dense_0_kernel.detach(), head0), "T3: the head's weight did not change")
    check(all(p.grad is not None for p in clf.parameters()), "T3: a parameter ended a step with grad None")
    lines.append({
        "trainer": "SupervisedTrainer audio_mnist_classifier_config(10)", "compute_dtype": "f32",
        "loss": "ce", "batch": cb, "steps": csteps, "ms_per_step": clf_ms / csteps,
        "steps_per_s": csteps / (clf_ms / 1e3), "samples_per_s": csteps * cb / (clf_ms / 1e3),
        "fused_dense_launches": launches, "loss_before": loss0, "loss_after": loss1, "card": card,
    })
    del clf, ctr, cx, cy, cbatches

    # ----------------------------------- T4. GAN training, AudioMNIST
    asteps, ab = 5, 32
    acfg = dataclasses.replace(audio_mnist_bigan_config(), init_std=0.01)
    atr = GANTrainer(BiGAN(acfg, dev, seeded(args.seed + 29)), GANTrainConfig(batch_size=ab),
                     seed=args.seed + 30)
    adata = atr.upload_dataset(*gan_data(acfg, asteps * ab, rng, dev))
    before = {n: p.detach().clone() for n, p in atr.model.named_parameters()}
    fused_encoder_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ametrics = atr.fit_epoch(adata)
    audio_s = time.perf_counter() - t0  # the first steps: cuDNN's algorithm choice included
    launches = fused_encoder_forward.launches
    train_launches["fused_encoder:audio_mnist"] = (launches, asteps)
    print(f"T4 GAN training AudioMNIST: {asteps} steps in {audio_s:.2f} s (first steps); fused_encoder "
          f"launched {launches} times; metrics {ametrics}")
    check(all(np.isfinite(v) for v in ametrics.values()), f"T4: metrics {ametrics}")
    check(launches == asteps and atr.step == asteps, f"T4: {launches} launches in {atr.step} steps")
    changed(before, atr.model, "T4")
    check(atr.state_dict()["opt_d"]["count"] == 2 * asteps, "T4: Adam's D count")
    trunk_at_training_shape(f"audio trunk at batch {ab}", atr.model.encoder, adata["image"][:ab],
                            {k: v[:ab] for k, v in adata["attrs"].items()}, acfg.enc_plan,
                            args.seed + 36, dev)
    del atr, adata, before

    # ------------------------------------------------- T5. SCM fits
    n = 4000
    t = (rng.gamma(10, 1 / 5, n) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64 + rng.normal(0, 3, n)).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, n)).astype(np.float32)
    raw = {"thickness": t, "intensity": i, "slant": s, "digit": rng.integers(0, 10, n)}
    obs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    obs.update({k: obs[k].reshape(-1, 1) for k in MNISTAttributeSCM.CONT})

    def mnist_fit(epochs):
        return MNISTAttributeSCM.fit(raw, steps=epochs, batch_size=1000, rng=seeded(args.seed + 31))

    def nll(scm, keys):
        lp = scm.log_prob(obs)
        return -sum(lp[k].mean().item() for k in keys)

    t0 = time.perf_counter()
    start_scm, scm = mnist_fit(0), mnist_fit(40)
    fit_s = time.perf_counter() - t0
    nll0, nll1 = nll(start_scm, MNISTAttributeSCM.CONT), nll(scm, MNISTAttributeSCM.CONT)
    print(f"T5 MNISTAttributeSCM.fit: 40 epochs of 4 steps in {fit_s:.2f} s; NLL {nll0:.4f} -> {nll1:.4f}")
    check(np.isfinite(nll1) and nll1 < nll0, f"T5: the MNIST SCM's NLL did not fall ({nll0} -> {nll1})")
    check(all(v.device.type == "cuda" for v in scm.params["intensity"][0]["mlp"][0].values()),
          "T5: the fitted SCM is not on the card")
    do = {"thickness": obs["thickness"] + 2}
    cf = scm.sample_cf(seeded(args.seed + 32), obs, do)
    check(sorted(cf) == sorted(raw) and all(torch.isfinite(v.float()).all() for v in cf.values()),
          "T5: counterfactual attributes")
    check(torch.equal(cf["thickness"], do["thickness"]), "T5: do(thickness) lost")
    check(torch.equal(cf["digit"].reshape(-1), obs["digit"]), "T5: digit changed without an intervention")
    check(torch.equal(cf["slant"], obs["slant"]) or (cf["slant"] - obs["slant"]).abs().max().item() < 1e-3,
          "T5: slant changed under do(thickness)")
    check((cf["intensity"] - obs["intensity"]).abs().max().item() > 0, "T5: intensity ignored its parent")

    country = rng.integers(0, 13, n)
    native = (country % 2 + (rng.random(n) < 0.1)) % 2
    araw = {k: rng.integers(0, c, n) for k, c in CARDINALITIES.items()}
    araw.update({"country_of_origin": country, "native_speaker": native,
                 "accent": (country + 3 * native + (rng.random(n) < 0.1)) % 15})
    obs = {k: torch.from_numpy(v).to(dev) for k, v in araw.items()}

    def audio_fit(epochs):
        return AudioMNISTAttributeSCM.fit(araw, steps=epochs, batch_size=1000, rng=seeded(args.seed + 33))

    t0 = time.perf_counter()
    start_scm, ascm = audio_fit(0), audio_fit(20)
    fit_s = time.perf_counter() - t0
    keys = AudioMNISTAttributeSCM.TRAINABLE
    nll0, nll1 = nll(start_scm, keys), nll(ascm, keys)
    print(f"T5 AudioMNISTAttributeSCM.fit: 20 epochs of 4 steps in {fit_s:.2f} s; NLL {nll0:.4f} -> {nll1:.4f}")
    check(np.isfinite(nll1) and nll1 < nll0, f"T5: the audio SCM's NLL did not fall ({nll0} -> {nll1})")
    new_country = (obs["country_of_origin"] + 1) % 13
    cf = ascm.sample_cf(seeded(args.seed + 34), obs, {"country_of_origin": new_country})
    check(torch.equal(cf["country_of_origin"], new_country), "T5: do(country_of_origin) lost")
    for k in ("digit", "age", "gender"):
        check(torch.equal(cf[k], obs[k]), f"T5: {k} changed under do(country_of_origin)")
    check(bool((cf["native_speaker"] != obs["native_speaker"]).any()),
          "T5: native_speaker ignored its parent after the fit")
    return train_launches, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--audio-batch", type=int, default=128,
                    help="batch of the AudioMNIST scoring path")
    ap.add_argument("--mc-rounds", type=int, default=4,
                    help="rounds of the AudioMNIST CF-effectiveness score")
    ap.add_argument("--profile", action="store_true",
                    help="also time each trunk layer alone beside its library conv, and write "
                         "torch.profiler tables of one MNIST counterfactual batch and one "
                         "AudioMNIST scoring round, in each type, and of five GAN training "
                         f"steps, to {PROFILE_DIR}/")
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
    peak = peaks(name)
    t0 = time.perf_counter()
    _build.load_libraries("fused_encoder", "fused_dense")
    print(f"build: fused_encoder, fused_dense in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in _build.BUILD_LOG.items():
        print(f"nvcc {lib}: {secs:.2f} s")
        for line in kernel_lines(log):
            print(line)

    # ---------------------------------------------- 2. kernel against plain
    b = args.batch
    plan = mnist_bigan_config().enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev)
    rng = np.random.default_rng(args.seed + 1)
    feats = torch.from_numpy(rng.normal(0, 1, (b, 28, 28, 5)).astype(np.float32)).to(dev)
    trunk = {dtype: check_trunk("MNIST trunk", params, feats, plan, dtype, splits=(0, 2))
             for dtype in DTYPES}

    # ------------------------------------------------- 3. the main path
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, b) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, b)).astype(np.float32)
    digit = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    raw = {"digit": digit, "thickness": t, "intensity": i, "slant": s}
    scaler = AttributeScaler.fit(MNIST_SPEC, raw)
    graph = build_mnist_graph(i.min(), i.max(), s.min(), s.max())
    scm = MNISTAttributeSCM(graph, *graph.init(seeded(args.seed), dev))
    xd = torch.from_numpy(x).to(dev)
    attrs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    do = {"thickness": torch.from_numpy(t + 2).reshape(-1, 1).to(dev)}

    kernels, engine_lines, x_cfs = [], [], {}
    for dtype in DTYPES:
        cfg = mnist_bigan_config(compute_dtype=dtype)
        # the same float32 parameters in both types: one seed
        engine = CounterfactualEngine(BiGAN(cfg, dev, seeded(args.seed + 1)), scm, scaler)
        fused_encoder_forward.launches = 0
        x_cf, cf_attrs = engine.counterfactual(xd, attrs, do)
        recon = engine.reconstruct(xd, attrs)
        torch.cuda.synchronize()
        launches = fused_encoder_forward.launches
        print(f"main path [{TAG[dtype]}]: fused_encoder launched {launches} times")
        check(launches > 0, f"the main path [{TAG[dtype]}] did not reach the fused_encoder kernel")
        x_cfs[dtype] = x_cf

        for img in (x_cf, recon):
            check(img.shape == (b, 28, 28, 1) and img.dtype == F32, f"image {tuple(img.shape)} {img.dtype}")
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
            _, epairs = cast_pairs(dict(enc.trunk.named_parameters()), dtype)
            zp = fused_encoder_reference(ef, epairs, conv_ops).float()
        z_err = (z - zp).abs().max().item()
        z_tol = GATE[dtype] * max(1.0, zp.abs().max().item())
        print(f"engine z [{TAG[dtype]}]: max|kernel - plain| = {z_err:.3e} (tol {z_tol:.3e})")
        check(z_err <= z_tol, "the engine's encoder disagrees with the plain trunk")

        # ----------------------------------------------------- 4. times
        err, cast, pairs, tfeats, plain = trunk[dtype]
        with torch.no_grad():
            kernel_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan))
            plain_ms = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=3, warmup=1)
            library_ms = time_ms(lambda: library_stack(tfeats, pairs, conv_ops))
            kernel_device_ms = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=10)
            lib_err = (library_stack(tfeats, pairs, conv_ops).float() - plain.float()).abs().max().item()
            # cuDNN's bf16 stack rounds at other places than the fused trunk: printed, gated in f32 only
            print(f"library stack MNIST trunk [{TAG[dtype]}]: max|library - plain| = {lib_err:.3e}")
            check(dtype != F32 or lib_err <= GATE[F32] * max(1.0, plain.float().abs().max().item()),
                  f"library stack disagrees with the plain version ({lib_err:.3e})")
            cf_ms = time_ms(lambda: engine.counterfactual(xd, attrs, do), reps=10, warmup=2)
            stages_ms = engine_stages_ms(engine, xd, attrs, do)
        flops, nbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops, tfeats.element_size())
        kernels.append(row("fused_encoder", dtype, "imagecfgen_torch/csrc/fused_encoder.cu",
                           "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches, err,
                           kernel_ms, plain_ms, library_ms, flops, nbytes, peak, card, batch=b,
                           device_ms=kernel_device_ms))
        engine_lines.append({
            "engine": "counterfactual do(thickness+2)",
            "compute_dtype": TAG[dtype],
            "batch": b,
            "ms_per_batch": cf_ms,
            "images_per_s": b / (cf_ms / 1e3),
            "stages_ms": stages_ms,
            "card": card,
        })
        if args.profile:
            layer_times("MNIST trunk", pairs, conv_ops, tfeats, dtype)
            profile_path(lambda: engine.counterfactual(xd, attrs, do), f"chip_smoke_profile_{TAG[dtype]}.txt")
        del engine
    diff = (x_cfs[BF16] - x_cfs[F32]).abs().max().item()
    print(f"main path: max|x_cf(bf16) - x_cf(f32)| = {diff:.3e} (printed, not gated)")
    del trunk, x_cfs

    # ------------------------------------------- A2-A4. the AudioMNIST path
    audio_rows, score_lines = audio_phases(args, dev, card, peak)
    kernels += audio_rows

    # ------------------------------------------------ T1-T6. training
    train_launches, train_lines = training_phases(args, dev, card)
    for kernel in kernels:  # training is float32: the bf16 rows have no training launches
        count, steps = train_launches[kernel["name"]] if kernel["dtype"] == "f32" else (None, None)
        check(count is None or count > 0, f"the training path did not reach the {kernel['name']} kernel")
        kernel.update(train_launches=count, train_steps=steps)
    for line in engine_lines + score_lines + train_lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": kernels}))

    # ---------------------------------------------------------- 5. the end
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
