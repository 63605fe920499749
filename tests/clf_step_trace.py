"""The AudioMNIST 60-way subject classifier's training run in both packages
on the CPU, side by side: the port's ``SupervisedTrainer`` and the JAX
package's, from the same parameters (the JAX CLI's initialisation at
``--seed``), on the training split, labels and validation runs that
``train_audio_mnist_clf.py --attribute subject`` takes, with the same numpy
permutation each epoch fed to both. The classifier has no dropout and no
batch norm, so a run is fixed by its initialisation and its batch order.

    python tests/clf_step_trace.py [--seed 0] [--epochs 30] [--width 1.0] [--out PATH] [--save-dir DIR]
    python tests/clf_step_trace.py --bisect [--seed 0] [--width 1.0] [--out PATH]

Each epoch prints both packages' mean loss, both ``val_acc`` and the
relative distance ``|port - jax| / |jax|`` of the parameters (all of them,
in float64); the distance after step 1 is printed and recorded on its own.
The record (``--out``, default
``imagecfgen_torch/tools/battery_records/clf-step-trace-subject.json``)
holds one entry a seed, rewritten in place, so seeds run one after the
other fill one file. ``--save-dir`` writes both trained classifiers as the
JAX CLI writes its file (``DIR/jax/`` and ``DIR/port/``, each
``audio-mnist-subject-clf.tar``): the port's in the JAX package's format, so
the JAX scripts read it too. JAX runs in exact float32, jit on for each step.

``--bisect`` takes step 1 apart by layer, against a float64 forward and
backward of the same plan (:func:`bisect`): each layer's pre-activations in
each package against float64 (relative error, and how many lie on the other
side of LeakyReLU's kink) and each parameter's gradient in each package
against float64 and against each other. It writes ``bisect`` into the
seed's entry.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RECORD = os.path.join(REPO, "imagecfgen_torch", "tools", "battery_records", "clf-step-trace-subject.json")
N_SUBJECTS = 60


def relative_distance(want, have) -> float:
    """``|have - want| / |want|`` over every tensor of two equal-keyed
    dicts, in float64."""
    num = sum(float(((have[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def jax_params_of(module):
    """The port classifier's parameters as the JAX package's tree
    (``{"trunk": {name: array}}``, HWIO conv and (in, out) dense kernels)."""
    import numpy as np

    trunk = {}
    for name, v in module.trunk.state_dict().items():
        v = v.detach().cpu().numpy()
        if name.startswith("conv_") and name.endswith("_kernel"):
            v = v.transpose(2, 3, 1, 0)
        elif name.startswith("dense_") and name.endswith("_kernel"):
            v = v.T
        trunk[name] = np.ascontiguousarray(v, np.float32)
    return {"trunk": trunk}


def training_split(data, batch: int, seed: int):
    """(images, one-hot subjects, validation images, validation subjects,
    statistics) as ``train_audio_mnist_clf.py:46-68`` takes them, and the
    rows of the first batch the trace draws."""
    import jax.numpy as jnp
    import numpy as np

    from imagecfgen_tpu.cli.audio_common import prepare_training_arrays

    x, _, stats = prepare_training_arrays(data)
    idx = data.split_indices(excluded_runs=data.training_excluded_runs)
    y = np.eye(N_SUBJECTS, dtype=np.float32)[data.raw["subject"][idx] - 1]
    vidx = np.nonzero(np.isin(data.raw["run"], data.validation_runs))[0]
    v_spects, _, _ = data.all_spectrograms(excluded_runs=data.validation_excluded_runs)
    xv = np.asarray(stats.spect_to_img(jnp.asarray(v_spects)))[..., None]
    first = np.random.default_rng(seed + 1000).permutation(len(x))[:batch]
    return x, y, xv, data.raw["subject"][vidx] - 1, stats, first


def bisect(seed: int = 0, width: float = 1.0, batch: int = 128, data=None) -> dict:
    """Step 1 of the trace taken apart by layer (see the module's
    docstring); returns the bisection's entry."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch
    import torch.nn.functional as F

    from imagecfgen_tpu.cli.audio_common import load_audio_dataset
    from imagecfgen_tpu.models import classifier as jclf
    from imagecfgen_tpu.ops import conv as jconv
    from imagecfgen_tpu.train.clf_trainer import SupervisedTrainConfig as JConfig
    from imagecfgen_tpu.train.clf_trainer import SupervisedTrainer as JTrainer
    from imagecfgen_torch.core.convert import classifier_params_from_jax, plan_state_dict_from_jax
    from imagecfgen_torch.models import classifier as tclf
    from imagecfgen_torch.ops import conv as tconv

    data = load_audio_dataset(None) if data is None else data
    x, y, _, _, _, first = training_split(data, batch, seed)
    xb, yb = x[first], y[first]
    jm = jclf.CNNClassifier(jclf.audio_mnist_classifier_config(N_SUBJECTS, width=width))
    params = jax.device_get(JTrainer(jm, JConfig(batch_size=batch)).init_state(
        jax.random.PRNGKey(seed), jnp.zeros((2, 128, 128, 1))).params)
    port = classifier_params_from_jax(params, tclf.audio_mnist_classifier_config(N_SUBJECTS, width=width), "cpu")
    plan, p = port.cfg.plan, params["trunk"]

    def preacts(conv, dense, lrelu, h):
        """Each conv's and dense layer's output, before its LeakyReLU."""
        out, ci, di = [], 0, 0
        for op in plan:
            if op[0] == "conv":
                h = conv(h, ci, op)
                ci += 1
                out.append(h)
            elif op[0] == "dense":
                h = dense(h, di)
                di += 1
                out.append(h)
            elif op[0] == "lrelu":
                h = lrelu(h, op[1])
            elif op[0] == "flatten":
                h = h.reshape(h.shape[0], -1)
        return out

    sd = {k: v.detach().double().requires_grad_() for k, v in port.trunk.named_parameters()}
    f64 = preacts(lambda h, i, op: tconv.conv2d(h, sd[f"conv_{i}_kernel"], op[3], op[4]) + sd[f"conv_{i}_bias"],
                  lambda h, i: h @ sd[f"dense_{i}_kernel"].t() + sd[f"dense_{i}_bias"],
                  F.leaky_relu, torch.from_numpy(xb).double())
    (-(torch.from_numpy(yb).double() * torch.log_softmax(f64[-1], -1)).sum(-1).mean()).backward()
    tp = dict(port.trunk.named_parameters())
    with torch.no_grad():
        t32 = preacts(lambda h, i, op: tconv.conv2d(h, tp[f"conv_{i}_kernel"], op[3], op[4]) + tp[f"conv_{i}_bias"],
                      lambda h, i: h.float() @ tp[f"dense_{i}_kernel"].t() + tp[f"dense_{i}_bias"],
                      F.leaky_relu, torch.from_numpy(xb))
    j32 = preacts(lambda h, i, op: jconv.conv2d(h, p[f"conv_{i}_kernel"], op[3], op[4]) + p[f"conv_{i}_bias"],
                  lambda h, i: jnp.dot(h, p[f"dense_{i}_kernel"]) + p[f"dense_{i}_bias"],
                  lambda h, s: jnp.where(h >= 0, h, s * h), jnp.asarray(xb))

    def loss_fn(prm):
        return optax.softmax_cross_entropy(jm.apply({"params": prm}, jnp.asarray(xb), train=True),
                                           jnp.asarray(yb)).mean()

    jg = plan_state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss_fn))(params))["trunk"])
    logits = port(torch.from_numpy(xb), train=True)
    (-(torch.from_numpy(yb) * torch.log_softmax(logits, -1)).sum(-1).mean()).backward()
    rel = lambda a, b: float((torch.as_tensor(np.asarray(a)).double() - b).norm() / b.norm())  # noqa: E731
    layers = []
    for i, truth in enumerate(f64):
        truth = truth.detach()
        kink = truth >= 0
        layers.append({"layer": i, "elements": truth.numel(),
                       "error": {"jax": rel(j32[i], truth), "port": rel(t32[i], truth)},
                       "kink_flips": {"jax": int((torch.as_tensor(np.asarray(j32[i]) >= 0) != kink).sum()),
                                      "port": int(((t32[i] >= 0) != kink).sum())}})
    grads = {n: {"jax": rel(jg[n], sd[n].grad), "port": rel(tp[n].grad, sd[n].grad), "port_vs_jax":
                 rel(tp[n].grad, jg[n].double())} for n in sd}
    return {"seed": seed, "width": width, "batch": batch, "layers": layers, "gradients": grads}


def trace(seed: int = 0, epochs: int = 30, width: float = 1.0, batch: int = 128, lr: float = 1e-4,
          data=None, save_dir=None, log=print):
    """Both packages' runs; returns the record entry of ``seed``. ``data``:
    the JAX package's ``AudioMNISTData`` (the full stand-in when None)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from imagecfgen_tpu.cli.audio_common import load_audio_dataset
    from imagecfgen_tpu.core.checkpoint import save_checkpoint
    from imagecfgen_tpu.models import classifier as jclf
    from imagecfgen_tpu.train.clf_trainer import SupervisedTrainConfig as JConfig
    from imagecfgen_tpu.train.clf_trainer import SupervisedTrainer as JTrainer
    from imagecfgen_torch.core.convert import classifier_params_from_jax
    from imagecfgen_torch.models import classifier as tclf
    from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer

    data = load_audio_dataset(None) if data is None else data
    x, y, xv, yv, stats, _ = training_split(data, batch, seed)

    jcfg = jclf.audio_mnist_classifier_config(N_SUBJECTS, width=width)
    jtr = JTrainer(jclf.CNNClassifier(jcfg), JConfig(learning_rate=lr, batch_size=batch))
    st = jtr.init_state(jax.random.PRNGKey(seed), jnp.zeros((2, 128, 128, 1)))
    jstep = jax.jit(jtr.train_step)
    port = classifier_params_from_jax(jax.device_get(st.params), tclf.audio_mnist_classifier_config(
        N_SUBJECTS, width=width), "cpu")
    tr = SupervisedTrainer(port, SupervisedTrainConfig(learning_rate=lr, batch_size=batch), "cpu")
    xv_t = torch.from_numpy(xv)

    def distance() -> float:
        want = classifier_params_from_jax(jax.device_get(st.params), port.cfg, "cpu").state_dict()
        return relative_distance(want, port.state_dict())

    rng = np.random.default_rng(seed + 1000)
    n, rows, step1, t0 = len(x), [], None, time.perf_counter()
    nb = n // batch
    log(f"seed {seed}: {n} training clips, {nb} steps an epoch, {len(xv)} validation clips; distance at init "
        f"{distance():.3e}")
    for epoch in range(epochs):
        perm = rng.permutation(n)[:nb * batch]
        losses = []
        for i in range(nb):
            sel = perm[i * batch:(i + 1) * batch]
            st, m = jstep(st, {"x": jnp.asarray(x[sel]), "y": jnp.asarray(y[sel])})
            got = tr.train_step({"x": torch.from_numpy(x[sel]), "y": torch.from_numpy(y[sel])})
            losses.append((float(m["loss"]), got["loss"].item()))
            if step1 is None:
                step1 = {"distance": distance(), "loss": list(losses[0])}
                log(f"step 1: loss jax {losses[0][0]:.6f} port {losses[0][1]:.6f}, distance {step1['distance']:.3e}")
        row = {"epoch": epoch + 1, "loss": [float(np.mean([a for a, _ in losses])), float(np.mean([b for _, b in losses]))],
               "val_acc": [jtr.accuracy(st, xv, yv), tr.accuracy(xv_t, yv)], "distance": distance(),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        log(f"epoch {epoch + 1}/{epochs}: loss jax {row['loss'][0]:.4f} port {row['loss'][1]:.4f} "
            f"val_acc jax {row['val_acc'][0]:.4f} port {row['val_acc'][1]:.4f} distance {row['distance']:.3e} "
            f"({row['seconds']:.0f} s)")
    if save_dir:
        meta = {"kind": "audio-mnist-clf", "attribute": "subject", "n_classes": N_SUBJECTS, "width": width}
        for pkg, params in (("jax", jax.device_get(st.params)), ("port", jax_params_of(port))):
            os.makedirs(os.path.join(save_dir, pkg), exist_ok=True)
            save_checkpoint(os.path.join(save_dir, pkg, "audio-mnist-subject-clf.tar"),
                            {"params": params, "spect_mean": np.asarray(stats.mean),
                             "spect_std": np.asarray(stats.std)}, meta=meta)
    return {"seed": seed, "width": width, "batch": batch, "learning_rate": lr, "epochs": epochs,
            "steps_per_epoch": nb, "train_clips": n, "validation_clips": len(xv), "step1": step1,
            "rows": rows, "final_val_acc": rows[-1]["val_acc"] if rows else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--out", default=RECORD)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--bisect", action="store_true", help="take step 1 apart by layer instead of tracing")
    args = p.parse_args(argv)
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path[:0] = [REPO, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.bisect:
        got = {"bisect": bisect(args.seed, args.width)}
        log(json.dumps(got["bisect"]))
    else:
        got = trace(args.seed, args.epochs, args.width, save_dir=args.save_dir, log=log)
    record = {"seeds": {}}
    if os.path.exists(args.out):  # read now: another seed's run may have written it meanwhile
        with open(args.out) as f:
            record = json.load(f)
    record.update({"trace": "audio-mnist subject classifier", "platform": "cpu", "cpu_count": os.cpu_count()})
    record["seeds"].setdefault(str(args.seed), {}).update(got)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
