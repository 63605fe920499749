"""The JAX package's MNIST battery stages on the CPU: the witness that says
whether the port's quality-battery records or the JAX package's TPU record
(``RESULTS.md:454-461``) is the one off, on the same data.

    python tests/jax_cpu_battery.py DIR --hard [--epochs 10] --stages scm,clf,vae,vae_score,...
    python -m imagecfgen_torch.tools.quality_battery --report DIR/jax-cpu-record.json

``DIR`` holds the battery's data (``mnist-{x,a}-{train,test}.npy``, made by
the port's or the JAX package's synthesis, which agree bit for bit). Each
stage is ``tools/quality_battery.sh``'s command line, taken from
``imagecfgen_torch.tools.quality_battery.stages``, run through the JAX
package's own top-level script in a subprocess pinned to the CPU, where JAX
computes in exact float32. The record, ``DIR/jax-cpu-record.json``, has the
port's record format (``compare`` and ``--report`` read it), with every
epoch's printed numbers of each training stage besides.

Two substitutions, so that the stages run in hours and not days on the
CPU; neither changes what is computed, and the JAX package's files are not
changed:

- XLA's CPU backend runs the ops inside a ``lax.scan`` about 30 times
  slower than the same ops outside one, and every trainer scans its epoch
  inside a jitted program (unrolled, the program takes longer to compile
  than to run): the harness runs the CLIs with jit off and each scan as a
  loop of its jitted step (:func:`scan_by_steps`: the same steps in the
  same order).
- It takes about 6 s for one step of the MNIST VAE at batch 64, nearly all
  of it in the gradients of the input-dilated transposed convs
  (``ops/conv.py``): the harness swaps ``conv_transpose2d`` in
  ``models/layers.py`` for :func:`phase_conv_transpose2d`, the same sums
  of the same products split by output phase into ``s*s`` plain
  convolutions (0.44 s a step; ``tests/test_torch_quality_battery.py``
  holds it to the package's version).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import runpy
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = "jax-cpu-record.json"


def phase_conv_transpose2d(x, w, stride=1, padding=0, output_padding=0, accum_dtype=None):
    """``imagecfgen_tpu.ops.conv.conv_transpose2d`` as the sum of its
    phases: output row ``s*q + r`` takes the taps ``t = t0, t0 + s, ...``
    with ``t0 = (k - 1 - p - r) mod s``, on input rows ``q + c + j``, a
    stride-1 convolution of the undilated input with the sub-kernel
    ``w[t0::s]``. The phases are interleaved by a reshape."""
    import jax.numpy as jnp
    from jax import lax

    from imagecfgen_tpu.ops import conv as jconv

    sh, sw = jconv._pair(stride)
    if (sh, sw) == (1, 1):
        return jconv.conv_transpose2d(x, w, stride, padding, output_padding, accum_dtype)
    (ph, pw), (oh, ow) = jconv._pair(padding), jconv._pair(output_padding)
    k, n_in = w.shape[:2], x.shape[1:3]
    n_out = [(i - 1) * s - 2 * p + kk + o for i, s, p, kk, o in zip(n_in, (sh, sw), (ph, pw), k, (oh, ow))]
    q_max = [-(-n // s) for n, s in zip(n_out, (sh, sw))]

    def phase(axis, r):
        """(first tap, input offset c, rows of this phase) along one axis."""
        s, lo, kk = (sh, sw)[axis], k[axis] - 1 - (ph, pw)[axis], k[axis]
        t0 = (lo - r) % s
        return t0, (r + t0 - lo) // s, -(-(n_out[axis] - r) // s), len(range(t0, kk, s))

    rows = []
    for rh in range(sh):
        cols = []
        for rw in range(sw):
            (th, ch, qh, nh), (tw, cw, qw, nw) = phase(0, rh), phase(1, rw)
            if nh == 0 or nw == 0:
                y = jnp.zeros((x.shape[0], qh, qw, w.shape[3]), accum_dtype or x.dtype)
            else:
                pad = [(0, 0, 0), (-ch, qh - 1 + ch + nh - 1 - (n_in[0] - 1), 0),
                       (-cw, qw - 1 + cw + nw - 1 - (n_in[1] - 1), 0), (0, 0, 0)]
                y = lax.conv_general_dilated(lax.pad(x, jnp.zeros((), x.dtype), pad), w[th::sh, tw::sw],
                                             (1, 1), "VALID", dimension_numbers=jconv._DIMS,
                                             preferred_element_type=accum_dtype)
            cols.append(jnp.pad(y, [(0, 0), (0, q_max[0] - qh), (0, q_max[1] - qw), (0, 0)]))
        rows.append(jnp.stack(cols, axis=3))  # (B, Qh, Qw, sw, C)
    y = jnp.stack(rows, axis=2)  # (B, Qh, sh, Qw, sw, C)
    b, c = x.shape[0], w.shape[3]
    return y.reshape(b, q_max[0] * sh, q_max[1] * sw, c)[:, :n_out[0], :n_out[1]]


def scan_by_steps(f, init, xs=None, length=None, reverse=False, unroll=1, **kwargs):
    """``lax.scan`` as a Python loop of ``f`` compiled alone (jit on for
    the step, whatever the context)."""
    import jax
    import jax.numpy as jnp

    n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
    step, carry, ys = jax.jit(f), init, []
    with jax.disable_jit(False):
        for i in (reversed(range(n)) if reverse else range(n)):
            carry, y = step(carry, None if xs is None else jax.tree_util.tree_map(lambda v: v[i], xs))
            ys.append(y)
    if reverse:
        ys.reverse()
    return carry, jax.tree_util.tree_map(lambda *v: jnp.stack(v), *ys) if ys else None


def run_script(script: str, argv) -> None:
    """``script`` (a top-level CLI of the JAX package) as ``__main__``, with
    jit off but for each scan's step (:func:`scan_by_steps`) and
    :func:`phase_conv_transpose2d` in the layers' place."""
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path.insert(0, REPO)
    import jax

    from imagecfgen_tpu.models import layers

    jax.lax.scan = scan_by_steps
    layers.conv_transpose2d = phase_conv_transpose2d
    sys.argv = [script, *argv]
    with jax.disable_jit():
        runpy.run_path(os.path.join(REPO, script), run_name="__main__")


def per_epoch(text: str):
    """Every ``epoch i/n: key=value ...`` line's numbers."""
    out = []
    for line in text.splitlines():
        m = re.match(r"epoch (\d+)/\d+: (.*)", line)
        if m:
            vals = re.findall(r"([-\w()]+)=(-?[0-9.]+(?:e[-+]?\d+)?)", m.group(2))
            out.append({"epoch": int(m.group(1)), **{k: float(v) for k, v in vals}})
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--exec"]:
        run_script(argv[1], argv[2:])
        return 0
    sys.path.insert(0, REPO)
    from imagecfgen_torch.tools import quality_battery as qb

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dir")
    p.add_argument("--stages", required=True, help="comma-separated, in the battery's order")
    known, rest = p.parse_known_args(argv)
    args = qb.parser.parse_args([known.dir, *rest])
    d = qb.data_dir(args)
    path = os.path.join(d, RECORD)
    record = qb.load_record(path) or {"stages": {}}
    record.update({"battery": "mnist", "package": "imagecfgen_tpu", "platform": "cpu", "hard": args.hard,
                   "epochs": args.epochs, "budgets": {k: getattr(args, k) for k in qb.BUDGETS},
                   "cpu_count": os.cpu_count()})
    wanted = known.stages.split(",")
    by_name = {s.name: s for s in qb.stages(args)}
    for name in wanted:
        stage = by_name[name]
        script = f"{stage.cli}.py"
        print(f"=== {name}: {script} {' '.join(stage.argv)}", flush=True)
        t0 = time.perf_counter()
        with open(os.path.join(d, f"{name}.jax.log"), "w") as log:  # the output as it comes
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--exec", script, *stage.argv],
                                    cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    env={**os.environ, "PYTHONUNBUFFERED": "1"})
            out = []
            for line in proc.stdout:
                out.append(line)
                log.write(line)
                log.flush()
        secs, out = time.perf_counter() - t0, "".join(out)
        if proc.wait():
            print(out[-3000:])
            raise RuntimeError(f"{script} exited with {proc.returncode}")
        record["stages"][name] = {"cli": stage.cli, "argv": stage.argv, "seconds": secs,
                                  "printed": stage.parse(out), "epochs": per_epoch(out)}
        record["scores"] = qb.scores_of(record["stages"])
        qb.write_record(path, record)
        print(f"=== {name}: {secs:.1f} s {json.dumps(record['stages'][name]['printed'])[:300]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
