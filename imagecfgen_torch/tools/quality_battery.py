"""The MNIST quality battery at a real training budget, through the port's
CLIs (the port of ``tools/quality_battery.sh``).

    python -m imagecfgen_torch.tools.quality_battery [DIR] [--hard] [--fused] [--seed 0]
        [--epochs 600] [--resume] [--stages bigan,finetune] [--device cuda|cpu]
    python -m imagecfgen_torch.tools.quality_battery --report RECORD [RECORD ...]

Runs the shell script's stages in its order and with its flags, each through
the port CLI's own ``main(argv)`` in this process: synthesis (8,192 training
and 2,048 test glyphs), the BiGAN (``--epochs`` epochs, d = 3), its encoder
fine-tune, the attribute SCM, the classifier, the VAE, then every score: the
CF digit accuracy of the BiGAN (trained and fine-tuned E) and of the VAE,
both generated-sample accuracies and both measured-CF tables. ``--hard`` adds
the script's ``HARD=1`` flags: pixel noise at synthesis, the compound
held-out shift of the CF scores and the held-out thickness shift of the
measured CFs.

``DIR`` (default ``.battery_torch`` or, under ``--hard``,
``.battery_torch_hard``) holds the data and the default arm's models.
``--fused`` (the trainer's ``--throughput``) and ``--seed N`` other than 0
train the BiGAN and its fine-tune in an arm directory of their own
(``DIR_fused``, ``DIR_seed1``, ...) and share DIR's data, SCM, classifier
and VAE, training them there only when they are missing.

A fresh run removes the arm's model files first and starts a new record.
Under ``--resume`` a stage whose artifact is complete is skipped, the BiGAN
stage continues its checkpoint (every 10 epochs, bit for bit), and the record
keeps the entries of the stages skipped; a score is run again only when a
model was trained in this run or the record lacks it. So a budget can be
spread over several runs, and ``--stages`` (names below) runs a subset, for
example two arms' BiGANs side by side before their scores.

Each run writes ``battery-record.json`` in the arm directory: for every stage
its command line, seconds, the launches of ``fused_encoder`` and
``fused_dense``, and what it printed (every score; the BiGAN's D(G(z)),
D(E(x)) and steps/s an epoch), the card's name and power limit, and
``scores``, which :func:`compare` holds against the JAX package's record of
the hard battery at 600 epochs (``--report`` prints it, and a ``--fused``
arm's :func:`deltas` against the first record's). Each stage's output also goes
to ``<stage>.log`` in the arm directory.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import datetime
import importlib
import io
import json
import os
import re
import shutil
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

RECORD = "battery-record.json"

# the shell script's budgets and HARD=1 defaults
BUDGETS = {"epochs": 600, "finetune_steps": 60, "scm_steps": 2000, "clf_epochs": 20, "vae_steps": 100,
           "score_limit": 2048, "gen_n": 2048, "cf_limit": 256}
NOISE_STD, TARGET_SHIFT, HELD_OUT_SHIFT = 32.0, 1.5, (1.5, 32.0, 0.4)
TRAIN_GLYPHS, TEST_GLYPHS = 8192, 2048

# The JAX package's hard battery at 600 epochs (RESULTS.md:454-461) and its
# FUSED=1 arm (RESULTS.md:481-490), one seed each.
JAX_HARD = {
    "bigan_cf_digit_accuracy": 0.8467,
    "bigan_cf_digit_accuracy_finetuned": 0.8389,
    "bigan_generated_accuracy": 0.8027,
    "vae_cf_digit_accuracy": 0.9521,
    "vae_generated_accuracy": 0.9810,
    "bigan_measured_cf": {"thickness": 0.8929, "intensity": 13.23, "slant": 0.0788},
    "vae_measured_cf": {"thickness": 0.1706, "intensity": 19.16, "slant": 0.0752},
}
JAX_HARD_FUSED = {
    "bigan_cf_digit_accuracy": 0.7959,
    "bigan_cf_digit_accuracy_finetuned": 0.7964,
    "bigan_generated_accuracy": 0.7969,
    "bigan_measured_cf": {"thickness": 0.9436, "intensity": 10.39, "slant": 0.0947},
}
# The port's bands around JAX_HARD: an absolute distance for the accuracies,
# a factor either way for the measured-CF errors. Fixed before any run.
ACCURACY_BANDS = {"bigan_cf_digit_accuracy": 0.05, "bigan_cf_digit_accuracy_finetuned": 0.05,
                  "bigan_generated_accuracy": 0.05, "vae_cf_digit_accuracy": 0.02,
                  "vae_generated_accuracy": 0.02}
ERROR_FACTOR = 1.5
ATTRIBUTES = ("thickness", "intensity", "slant")


@dataclass
class Stage:
    name: str  # the record's key and --stages' name
    cli: str  # the module under imagecfgen_torch.cli
    argv: List[str]
    kind: str  # "data", "train" or "score"
    done: Callable[[], bool] = lambda: False  # the stage's artifact is complete
    device: bool = True  # pass --device (the dataset CLIs touch no tensor)
    shared: bool = False  # another arm's artifact (DIR's), which this arm takes over
    after_bigan: bool = False  # run again whenever the BiGAN was trained in this run
    parse: Callable[[str], Dict] = lambda text: {}


parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("dir", nargs="?", default=None,
                    help="data and the default arm's models (.battery_torch[_hard])")
parser.add_argument("--hard", action="store_true",
                    help="pixel noise at synthesis and held-out shifts in the scores (HARD=1)")
parser.add_argument("--fused", action="store_true",
                    help="train the BiGAN with --throughput, in DIR_fused (FUSED=1)")
parser.add_argument("--seed", type=int, default=0, help="the BiGAN's seed; not 0: in DIR_seedN")
parser.add_argument("--epochs", type=int, default=BUDGETS["epochs"], help="the BiGAN's epochs")
parser.add_argument("--resume", action="store_true",
                    help="keep the models and the record; skip every stage whose artifact is complete")
parser.add_argument("--stages", type=str, default=None,
                    help="run only these stages (comma-separated); default all")
parser.add_argument("--noise-std", type=float, default=NOISE_STD)
parser.add_argument("--target-shift", type=float, default=TARGET_SHIFT)
parser.add_argument("--held-out-shift", type=float, nargs=3, default=list(HELD_OUT_SHIFT))
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
for _key in ("finetune_steps", "scm_steps", "clf_epochs", "vae_steps", "score_limit", "gen_n", "cf_limit"):
    parser.add_argument(f"--{_key.replace('_', '-')}", type=int, default=BUDGETS[_key])
parser.add_argument("--train-glyphs", type=int, default=TRAIN_GLYPHS, help="small tests only")
parser.add_argument("--test-glyphs", type=int, default=TEST_GLYPHS, help="small tests only")
parser.add_argument("--workers", type=int, default=None, help="synthesis workers (the CLIs' default)")
parser.add_argument("--report", nargs="+", metavar="RECORD", default=None,
                    help="run nothing: print compare() of each record, and deltas() of a --fused "
                         "arm's against the first")


# ------------------------------------------------------------------ dirs


def data_dir(args) -> str:
    return os.path.abspath(args.dir or (".battery_torch_hard" if args.hard else ".battery_torch"))


def arm_dir(args) -> str:
    return data_dir(args) + ("_fused" if args.fused else "") + (f"_seed{args.seed}" if args.seed else "")


def own_model_files(args) -> List[str]:
    """The model files a fresh run of this arm removes: the BiGAN's, and
    the SCM's, classifier's and VAE's in the default arm (the shell
    script's list, with the classifier's real name)."""
    names = ["mnist-bigan.tar"]
    if arm_dir(args) == data_dir(args):
        names += ["mnist-vae.tar", "mnist_clf.tar", "mnist-attribute-scm.tar"]
    arm = arm_dir(args)
    fine = [f for f in os.listdir(arm) if f.startswith("mnist-bigan-finetuned-") and f.endswith(".tar")]
    return [p for p in (os.path.join(arm, n) for n in names + fine) if os.path.exists(p)]


# -------------------------------------------------------------- parsing


def parse_bigan(text: str) -> Dict:
    rows = re.findall(r"epoch (\d+)/\d+: D\(G\(z\)\)=(\S+) D\(E\(x\)\)=(\S+) \((\S+) steps/s", text)
    return {"epochs": [[int(e), float(d), float(eg), float(r)] for e, d, eg, r in rows]}


def parse_per_epoch(text: str) -> Dict:
    """The ``key=value`` numbers of the last epoch line, and steps/s of every
    epoch (fine-tune, VAE, classifier)."""
    lines = [ln for ln in text.splitlines() if ln.startswith("epoch ")]
    out = {"last": {k: float(v) for k, v in re.findall(r"([-\w()]+)=(-?[0-9.]+(?:e[-+]?\d+)?)",
                                                         lines[-1])} if lines else {}}
    rates = [float(r) for r in re.findall(r"\(([0-9.]+) steps/s\)", text)]
    if rates:
        out["steps_per_s"] = rates
    vals = re.findall(r"val_acc=([0-9.]+)", text)
    if vals:
        out["val_acc"] = [float(v) for v in vals]
    return out


def parse_scm(text: str) -> Dict:
    nll = re.findall(r"step (\d+)/\d+ nll=(-?[0-9.]+)", text)
    return {"nll": [[int(s), float(v)] for s, v in nll]}


def parse_score(text: str) -> Dict:
    """Every ``label: number`` line, and the measured CFs' dict of errors."""
    out = {}
    for line in text.splitlines():
        m = re.fullmatch(r"(median abs errors): (\{.*\})", line.strip())
        if m:
            out[m.group(1)] = {k: float(v) for k, v in ast.literal_eval(m.group(2)).items()}
            continue
        m = re.fullmatch(r"([^:]+): (-?[0-9.]+(?:e[-+]?\d+)?|nan)", line.strip())
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


# --------------------------------------------------------------- stages


def _epoch_of(path: str) -> Optional[int]:
    from ..core.checkpoint import load_meta

    return load_meta(path).get("epoch") if os.path.exists(path) else None


def _rows(path: str) -> Optional[int]:
    if not os.path.exists(path):
        return None
    import numpy as np

    return np.load(path, mmap_mode="r").shape[0]


def stages(args) -> List[Stage]:
    """The battery's stages, in ``tools/quality_battery.sh``'s order."""
    d, a = data_dir(args), arm_dir(args)
    m, own = d, a != d  # the scores read DIR's SCM, classifier and VAE and the arm's BiGAN
    j = os.path.join
    noise = ["--noise-std", f"{args.noise_std:g}"] if args.hard else []
    shift = ["--target-shift", f"{args.target_shift:g}"] if args.hard else []
    cf_shift = ["--held-out-shift", *(f"{v:g}" for v in args.held_out_shift)] if args.hard else []
    workers = ["--workers", str(args.workers)] if args.workers else []
    bigan, finetuned = j(a, "mnist-bigan.tar"), j(a, "mnist-bigan-finetuned-mse.tar")
    m_bigan = ["-m", bigan] if own else []

    def data(split, n):
        return lambda: _rows(j(d, f"mnist-x-{split}.npy")) == n and _rows(j(d, f"mnist-a-{split}.npy")) == n

    def exists(path):
        return lambda: os.path.exists(path)

    return [
        Stage("train_data", "create_train_dataset",
              ["--synthetic", str(args.train_glyphs), "--out-dir", d, *noise, *workers], "data",
              data("train", args.train_glyphs), device=False),
        Stage("test_data", "create_test_dataset",
              ["--synthetic", str(args.test_glyphs), "--out-dir", d, *noise, *workers], "data",
              data("test", args.test_glyphs), device=False),
        Stage("bigan", "train_mnist_image_scm",
              ["--data-dir", d, "--steps", str(args.epochs), "--d-updates-per-g-update", "3",
               "--save-images-every", "200", "--output-path", a, "--resume",
               *(["--throughput"] if args.fused else []), *(["--seed", str(args.seed)] if args.seed else [])],
              "train", lambda: _epoch_of(bigan) == args.epochs, parse=parse_bigan),
        Stage("finetune", "finetune_mnist_bigan",  # writes to the working directory: the arm's
              ["--data-dir", d, "--steps", str(args.finetune_steps), "--model-file", bigan], "train",
              exists(finetuned), after_bigan=True, parse=parse_per_epoch),
        Stage("scm", "train_mnist_attribute_scm",
              ["--data-dir", d, "--steps", str(args.scm_steps), "--output-path", m], "train",
              exists(j(m, "mnist-attribute-scm.tar")), shared=own, parse=parse_scm),
        Stage("clf", "train_mnist_clf", ["--data-dir", d, "--epochs", str(args.clf_epochs), "--output-path", m],
              "train", exists(j(m, "mnist_clf.tar")), shared=own, parse=parse_per_epoch),
        Stage("vae", "train_mnist_vae", ["--data-dir", d, "--steps", str(args.vae_steps), "--output-path", m],
              "train", lambda: _epoch_of(j(m, "mnist-vae.tar")) == args.vae_steps, shared=own,
              parse=parse_per_epoch),
        Stage("bigan_score", "mnist_bigan_score",
              ["--data-dir", d, "--model-dir", m, "--limit", str(args.score_limit), *m_bigan, *cf_shift],
              "score", parse=parse_score),
        Stage("bigan_score_finetuned", "mnist_bigan_score",
              ["--data-dir", d, "--model-dir", m, "--limit", str(args.score_limit), "-m", finetuned, *cf_shift],
              "score", parse=parse_score),
        Stage("vae_score", "mnist_vae_score",
              ["--data-dir", d, "--model-dir", m, "--limit", str(args.score_limit), *cf_shift],
              "score", parse=parse_score),
        Stage("generator_score", "mnist_generator_score", ["--model-dir", m, "--n", str(args.gen_n), *m_bigan],
              "score", parse=parse_score),
        Stage("vae_generator_score", "mnist_vae_generator_score", ["--model-dir", m, "--n", str(args.gen_n)],
              "score", parse=parse_score),
        Stage("gan_measured_cf", "mnist_gan_measured_cf",
              ["--data-dir", d, "--model-dir", m, "--limit", str(args.cf_limit), "--workers", "1", *shift,
               *(["--image-model", bigan] if own else [])],
              "score", parse=parse_score),
        Stage("vae_measured_cf", "mnist_vae_measured_cf",
              ["--data-dir", d, "--model-dir", m, "--limit", str(args.cf_limit), "--workers", "1", *shift],
              "score", parse=parse_score),
    ]


# Score stages that encode (through fused_encoder on the card); the two
# generator scores draw z from the prior and run no encoder.
ENCODING_SCORES = ("bigan_score", "bigan_score_finetuned", "vae_score", "gan_measured_cf", "vae_measured_cf")


def scores_of(entries: Dict) -> Dict:
    """The numbers :func:`compare` reads, from the stages' parsed output."""
    def printed(stage, label):
        return entries.get(stage, {}).get("printed", {}).get(label)

    return {
        "bigan_cf_digit_accuracy": printed("bigan_score", "cf digit accuracy"),
        "bigan_cf_digit_accuracy_finetuned": printed("bigan_score_finetuned", "cf digit accuracy"),
        "bigan_generated_accuracy": printed("generator_score", "generated-sample digit accuracy"),
        "vae_cf_digit_accuracy": printed("vae_score", "vae cf digit accuracy"),
        "vae_generated_accuracy": printed("vae_generator_score", "vae generated-sample digit accuracy"),
        "bigan_measured_cf": printed("gan_measured_cf", "median abs errors"),
        "vae_measured_cf": printed("vae_measured_cf", "median abs errors"),
    }


# -------------------------------------------------------------- compare


def compare(record: Dict, reference: Dict = JAX_HARD) -> Dict:
    """Hold ``record["scores"]`` against ``reference`` in the bands above
    and the paper's split (the VAE above the BiGAN on both digit
    accuracies; the BiGAN below the VAE on intensity error). Returns
    ``{"ok", "rows": [{metric, port, jax, band, ok}], "missed": [metric]}``;
    a missing number misses its band."""
    s, rows = record["scores"], []
    for key, width in ACCURACY_BANDS.items():
        got, want = s.get(key), reference[key]
        rows.append({"metric": key, "port": got, "jax": want, "band": f"±{width:g}",
                     "ok": got is not None and abs(got - want) <= width})
    for model in ("bigan", "vae"):
        key = f"{model}_measured_cf"
        for attr in ATTRIBUTES:
            got, want = (s.get(key) or {}).get(attr), reference[key][attr]
            rows.append({"metric": f"{key}.{attr}", "port": got, "jax": want, "band": f"×/÷{ERROR_FACTOR:g}",
                         "ok": got is not None and want / ERROR_FACTOR <= got <= want * ERROR_FACTOR})
    try:
        split = {
            "vae_above_bigan_cf": s["vae_cf_digit_accuracy"] > s["bigan_cf_digit_accuracy"],
            "vae_above_bigan_generated": s["vae_generated_accuracy"] > s["bigan_generated_accuracy"],
            "bigan_below_vae_intensity_error":
                s["bigan_measured_cf"]["intensity"] < s["vae_measured_cf"]["intensity"],
        }
    except (KeyError, TypeError):
        split = dict.fromkeys(("vae_above_bigan_cf", "vae_above_bigan_generated",
                               "bigan_below_vae_intensity_error"), False)
    rows += [{"metric": k, "port": v, "jax": True, "band": "holds", "ok": v} for k, v in split.items()]
    missed = [r["metric"] for r in rows if not r["ok"]]
    return {"ok": not missed, "rows": rows, "missed": missed}


def deltas(arm: Dict, default: Dict) -> Dict:
    """``arm - default`` for each BiGAN score both records hold, and JAX's
    FUSED=1 deltas beside them."""
    out = {}
    for key, want in JAX_HARD_FUSED.items():
        a, b = arm["scores"].get(key), default["scores"].get(key)
        if isinstance(want, dict):
            for attr in ATTRIBUTES:
                if a and b:
                    out[f"{key}.{attr}"] = {"port": a[attr] - b[attr], "jax": want[attr] - JAX_HARD[key][attr]}
        elif a is not None and b is not None:
            out[key] = {"port": a - b, "jax": want - JAX_HARD[key]}
    return out


# ------------------------------------------------------------------ run


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card; None where
    there is no ``nvidia-smi`` (a run on the CPU)."""
    from .gan_train_rate import card_line as query

    return query() if shutil.which("nvidia-smi") else None


class _Tee(io.TextIOBase):
    """Writes to a buffer, a log file and the real stdout."""

    def __init__(self, log, out):
        self.buf, self.log, self.out = io.StringIO(), log, out

    def write(self, s):
        self.buf.write(s)
        self.log.write(s)
        self.log.flush()
        self.out.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_stage(stage: Stage, args, cwd: str) -> Dict:
    """One stage through its CLI's ``main`` in ``cwd``, its launch counts
    set to 0 just before and read just after. A non-zero exit raises."""
    import torch

    from ..ops.fused_dense import fused_dense_lrelu
    from ..ops.fused_encoder import fused_encoder_forward

    argv = [*stage.argv, *(("--device", args.device) if stage.device else ())]
    main = importlib.import_module(f"imagecfgen_torch.cli.{stage.cli}").main
    cuda = args.device.startswith("cuda")
    print(f"=== {stage.name}: {stage.cli} {' '.join(argv)}", flush=True)
    with open(os.path.join(cwd, f"{stage.name}.log"), "w") as log, contextlib.chdir(cwd):
        tee = _Tee(log, sys.stdout)
        if cuda:
            torch.cuda.synchronize()
        fused_encoder_forward.launches = fused_dense_lrelu.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            code = main(argv)
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {"fused_encoder": fused_encoder_forward.launches, "fused_dense": fused_dense_lrelu.launches}
    if code:
        raise RuntimeError(f"{stage.cli} exited with {code}")
    print(f"=== {stage.name}: {secs:.2f} s, launches {launches}", flush=True)
    return {"cli": stage.cli, "argv": argv, "seconds": secs, "launches": launches,
            "printed": stage.parse(tee.buf.getvalue())}


def load_record(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _relative(obj, base: str):
    """``obj`` with every path under ``base`` written relative to it."""
    if isinstance(obj, str):
        return obj[len(base):] if obj.startswith(base) else obj
    if isinstance(obj, list):
        return [_relative(v, base) for v in obj]
    if isinstance(obj, dict):
        return {k: _relative(v, base) for k, v in obj.items()}
    return obj


def write_record(path: str, record: Dict) -> None:
    """The record, its paths relative to the working directory."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_relative(record, os.path.join(os.getcwd(), "")), f, indent=1)
    os.replace(tmp, path)


def report(paths: Sequence[str], line: Callable[[str, Dict, List[Dict]], Dict]) -> int:
    """``--report``: run nothing, print ``line(path, record, records)`` of
    each record as one JSON line."""
    records = [load_record(p) for p in paths]
    for p, rec in zip(paths, records):
        print(json.dumps(line(p, rec, records)))
    return 0


def run_battery(args, argv: Optional[Sequence[str]], all_stages: List[Stage], path: str, header: Dict,
                own_files: Callable[[], List[str]], scores: Callable[[Dict], Dict],
                error: Callable[[str], None]) -> Dict:
    """Run ``all_stages`` in order (``args.stages``, ``args.resume``,
    ``args.device``; see the module's docstring) in the directory of
    ``path`` and write the record there after each stage: ``header``, the
    card, the runs (each with its ``argv``), every stage's entry and
    ``scores(entries)``. A fresh
    run first removes ``own_files()`` and keeps only the data stages'
    entries. Returns the record."""
    import torch

    names = [s.name for s in all_stages]
    wanted = set(names if args.stages is None else args.stages.split(","))
    if wanted - set(names):
        error(f"unknown stages {sorted(wanted - set(names))}; the stages are {names}")
    old = load_record(path) or {"stages": {}}
    if args.resume:
        entries = dict(old["stages"])
    else:  # a fresh run: no stale model is scored; the data (kept) keep their entries
        for f in own_files():
            os.remove(f)
        runs = old.get("runs", [])
        data = {s.name for s in all_stages if s.kind == "data"}
        entries = {k: dict(v, run=runs[v["run"]] if isinstance(v.get("run"), int) else v.get("run"))
                   for k, v in old["stages"].items() if k in data}
    card = card_line()
    record = {
        **header, "device": args.device, "torch": torch.__version__,
        "card": card, "runs": [*(old.get("runs", []) if args.resume else []), {
            "started": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            "argv": list(argv if argv is not None else sys.argv[1:]), "card": card,
            "cpu_count": os.cpu_count()}],
        "stages": entries,
    }
    run_no = len(record["runs"]) - 1
    trained = bigan_trained = False
    for stage in all_stages:
        complete = stage.done() if stage.name in wanted or stage.kind == "data" else None
        if stage.name not in wanted and not (stage.kind == "data" and not complete):
            continue
        if stage.kind == "score":
            skip = args.resume and stage.name in entries and not trained
        elif stage.kind == "data":
            skip = complete
        else:
            skip = complete and (args.resume or stage.shared) and not (stage.after_bigan and bigan_trained)
        if skip:
            if stage.name not in entries:
                entries[stage.name] = {"cli": stage.cli, "skipped": "artifact complete",
                                       "shared_from": header["dirs"]["data"] if stage.shared else None}
            print(f"=== {stage.name}: skipped (complete)", flush=True)
            continue
        entry = run_stage(stage, args, os.path.dirname(path))
        entry["run"] = run_no
        entries[stage.name] = entry
        trained |= stage.kind == "train"
        bigan_trained |= stage.name == "bigan"
        record["scores"] = scores(entries)
        write_record(path, record)
    record["scores"] = scores(entries)
    write_record(path, record)
    print(json.dumps({"record": path, "scores": record["scores"]}))
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser.parse_args(argv)
    if args.report:
        return report(args.report, lambda p, rec, records: {
            "record": p, "scores": rec["scores"], "compare": compare(rec),
            **({"deltas": deltas(rec, records[0])} if rec.get("fused") else {})})
    from ..device import resolve_device

    resolve_device(args.device)  # before minutes of synthesis: the card, unless the CPU is asked for
    d, a = data_dir(args), arm_dir(args)
    os.makedirs(d, exist_ok=True)
    os.makedirs(a, exist_ok=True)
    header = {
        "battery": "mnist", "hard": args.hard, "fused": args.fused, "seed": args.seed, "epochs": args.epochs,
        "glyphs": {"train": args.train_glyphs, "test": args.test_glyphs},
        "budgets": {k: getattr(args, k) for k in BUDGETS},
        "shifts": {"noise_std": args.noise_std, "target_shift": args.target_shift,
                   "held_out_shift": args.held_out_shift} if args.hard else None,
        "dirs": {"data": d, "arm": a},
    }
    run_battery(args, argv, stages(args), os.path.join(a, RECORD), header, lambda: own_model_files(args),
                scores_of, parser.error)
    return 0


if __name__ == "__main__":
    sys.exit(main())
