"""The AudioMNIST quality battery at a real training budget, through the
port's CLIs (the port of ``tools/audio_battery.sh``).

    python -m imagecfgen_torch.tools.audio_battery [DIR] [--epochs 300] [--vae-epochs 100]
        [--init-std 0.01] [--dtype bfloat16] [--no-vae] [--no-identity] [--seed 0]
        [--resume] [--stages bigan,scm] [--zip-path Z] [--device cuda|cpu]
    python -m imagecfgen_torch.tools.audio_battery --report DEFAULT_RECORD [SEED_RECORD ...]

Runs the shell script's stages in its order and with its flags, each through
the port CLI's own ``main(argv)`` in this process: the BiGAN (``--epochs``
epochs, d = 64, a checkpoint every 300), the attribute SCM (2,000 steps),
the digit classifier (30 epochs), the VAE (``--vae-epochs``), the BiGAN's
and the VAE's CF digit accuracy (one MC round), both generated-sample
accuracies (1,024 draws), then the identity stages: the 60-way subject
classifier, the subject-identity accuracy after a digit CF
(``audiomnist_cf_classifier_metric``) and the manifold-distance ratios
(``audiomnist_cf_eval``). The script's environment knobs are flags:
``EPOCHS`` ``--epochs``, ``VAE_EPOCHS`` ``--vae-epochs``, ``INIT_STD``
``--init-std``, ``DTYPE`` ``--dtype`` (the BiGAN's ``--compute-dtype``),
``VAE=0`` ``--no-vae``, ``IDENTITY=0`` ``--no-identity``, ``RESUME=1``
``--resume``; the zip, the script's second argument, ``--zip-path`` (the
synthetic stand-in without it).

``DIR`` (default ``.battery_torch_audio``, ``.battery_torch_audio_bf16``
under ``--dtype bfloat16``) holds the default arm's models. ``--seed N``
other than 0 trains the BiGAN in ``DIR_seedN`` and shares DIR's SCM,
classifiers and VAE, training them there only when they are missing.
``--resume``, ``--stages`` and the record are those of
:mod:`imagecfgen_torch.tools.quality_battery` (its stage runner and record
writer): ``battery-record.json`` in the arm directory holds every stage's
command line, seconds, launches of ``fused_encoder`` and ``fused_dense`` and
what it printed (the BiGAN's D(G(z)), D(E(x)) and steps/s an epoch), the
card's name and power limit, and ``scores``, which :func:`compare` holds
against the JAX package's record of the same arm (``--report`` prints it,
a seed arm's with the default arm's SCM and classifiers when the default
arm's record comes first).
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Optional, Sequence

from .quality_battery import (
    RECORD,
    Stage,
    _epoch_of,
    parse_bigan,
    parse_per_epoch,
    parse_scm,
    parse_score,
    report,
    run_battery,
)

# the shell script's defaults and fixed budgets
BUDGETS = {"epochs": 300, "vae_epochs": 100, "checkpoint_every": 300, "scm_steps": 2000, "clf_epochs": 30,
           "subject_clf_epochs": 30, "mc_rounds": 1, "gen_n": 1024}

# The JAX package's records (one seed each), and the port's bands around
# them, fixed before any run. The bf16 arm (``DTYPE=bfloat16 INIT_STD=0.01
# EPOCHS=1200 VAE=0 IDENTITY=0``): RESULTS.md:501-520, docs/bf16_audio_r05/.
JAX_BF16 = {"bigan_cf_digit_accuracy": 0.9833, "bigan_generated_accuracy": 0.9961, "scm_accent_nll": 0.6593,
            "digit_clf_val_acc": 1.0}
BF16_BANDS = {"bigan_cf_digit_accuracy": ("±", 0.03), "bigan_generated_accuracy": ("±", 0.03),
              "scm_accent_nll": ("±", 0.01), "digit_clf_val_acc": ("≥", 0.99)}
# The float32 identity arm (``INIT_STD=0.01 EPOCHS=1200``): RESULTS.md:311-313
# and 332-372, docs/identity_r05/.
JAX_F32_IDENTITY = {
    "bigan_cf_digit_accuracy": 0.9767, "bigan_generated_accuracy": 0.9902, "vae_cf_digit_accuracy": 1.0,
    "vae_generated_accuracy": 1.0,
    "subject_identity": {"bigan": 0.6002, "vae": 0.1015, "bigan_int": 0.6004},
    "mean_ratio": {"bigan": 0.9855, "vae": 0.9809, "bigan_int": 0.9852, "vae_int": 0.9728},
}
F32_IDENTITY_BANDS = {
    "bigan_cf_digit_accuracy": ("±", 0.03), "bigan_generated_accuracy": ("±", 0.03),
    "vae_cf_digit_accuracy": ("≥", 0.97), "vae_generated_accuracy": ("≥", 0.97),
    **{f"subject_identity.{m}": ("±", 0.05) for m in ("bigan", "vae", "bigan_int")},
    **{f"mean_ratio.{m}": ("±", 0.03) for m in ("bigan", "vae", "bigan_int", "vae_int")},
}
IDENTITY_SPLIT = 3.0  # the paper's split: the BiGAN keeps the subject at least 3x as often as the VAE
# Reported, not gated: the means of D(G(z)) and D(E(x)) over windows of
# epochs of the JAX bf16 arm's BiGAN stage (docs/bf16_audio_r05/bigan_stage.log).
# The port's count as held when D(G(z)) is within a factor of 2 of JAX's in
# the last three windows.
JAX_BF16_WINDOWS = {(91, 100): (0.3766, 0.6557), (291, 300): (0.1188, 0.8894), (591, 600): (0.0621, 0.9404),
                    (1191, 1200): (0.0372, 0.9643)}
WINDOW_FACTOR = 2.0

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("dir", nargs="?", default=None,
                    help="the default arm's models (.battery_torch_audio[_bf16])")
parser.add_argument("--epochs", type=int, default=BUDGETS["epochs"], help="the BiGAN's epochs (EPOCHS)")
parser.add_argument("--vae-epochs", type=int, default=BUDGETS["vae_epochs"], help="the VAE's (VAE_EPOCHS)")
parser.add_argument("--init-std", type=float, default=None, help="the BiGAN's conv init std (INIT_STD)")
parser.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                    help="the BiGAN's --compute-dtype (DTYPE); the other stages stay float32")
parser.add_argument("--no-vae", action="store_true", help="skip the VAE and its scores (VAE=0)")
parser.add_argument("--no-identity", action="store_true", help="skip the identity stages (IDENTITY=0)")
parser.add_argument("--seed", type=int, default=0, help="the BiGAN's seed; not 0: in DIR_seedN")
parser.add_argument("--resume", action="store_true",
                    help="keep the models and the record; skip every stage whose artifact is complete (RESUME=1)")
parser.add_argument("--stages", type=str, default=None,
                    help="run only these stages (comma-separated); default all")
parser.add_argument("--zip-path", type=str, default=None, help="the AudioMNIST zip; the stand-in without it")
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
for _key in ("scm_steps", "clf_epochs", "subject_clf_epochs", "gen_n"):
    parser.add_argument(f"--{_key.replace('_', '-')}", type=int, default=BUDGETS[_key])
parser.add_argument("--d", type=int, default=None, help="the BiGAN's and the VAE's --d (small tests only)")
parser.add_argument("--width", type=float, default=None, help="the classifiers' --width (small tests only)")
parser.add_argument("--batch-size", type=int, default=None,
                    help="the training CLIs' --batch-size (small tests only)")
parser.add_argument("--report", nargs="+", metavar="RECORD", default=None,
                    help="run nothing: print compare() of each record")


# ------------------------------------------------------------------ dirs


def data_dir(args) -> str:
    default = ".battery_torch_audio" + ("_bf16" if args.dtype == "bfloat16" else "")
    return os.path.abspath(args.dir or default)


def arm_dir(args) -> str:
    return data_dir(args) + (f"_seed{args.seed}" if args.seed else "")


def own_model_files(args) -> List[str]:
    """The files a fresh run of this arm removes: the shell script's list in
    the default arm; the BiGAN's and its ratio matrices in another."""
    a = arm_dir(args)
    default = a == data_dir(args)

    def own(f):
        if f.endswith(("_cf_metric_mat.npy", "_int_metric_mat.npy")) or f == "audio-mnist-bigan.tar":
            return True
        return default and (f in ("audio-mnist-vae.tar", "audio-mnist-attribute-scm.tar")
                            or re.fullmatch(r"audio-mnist-\w+-clf\.tar", f) is not None)

    return [os.path.join(a, f) for f in sorted(os.listdir(a)) if own(f)]


# -------------------------------------------------------------- parsing


def parse_identity(text: str) -> Dict:
    return {m: float(v) for m, v in re.findall(r"(\w+): subject-identity accuracy after digit CF = ([0-9.]+|nan)",
                                               text)}


def parse_ratios(text: str) -> Dict:
    return {m: float(v) for m, v in re.findall(r"(\w+): mean ratio ([0-9.]+|nan)", text)}


# --------------------------------------------------------------- stages


def stages(args) -> List[Stage]:
    """The battery's stages, in ``tools/audio_battery.sh``'s order."""
    d, a = data_dir(args), arm_dir(args)
    own, j = a != d, os.path.join
    zipf = ["--zip-path", args.zip_path] if args.zip_path else []

    def small(flag, value):  # a flag for small tests only, passed when given
        return [] if value is None else [flag, f"{value:g}"]

    batch = small("--batch-size", args.batch_size)
    bigan = j(a, "audio-mnist-bigan.tar")

    def exists(path):
        return lambda: os.path.exists(path)

    out = [
        Stage("bigan", "train_audio_mnist_bigan",
              [*zipf, *(["--init-std", f"{args.init_std:g}"] if args.init_std is not None else []),
               *(["--compute-dtype", args.dtype] if args.dtype else []), "--steps", str(args.epochs),
               "--checkpoint-every", str(BUDGETS["checkpoint_every"]), "--output-path", a, "--resume",
               *(["--seed", str(args.seed)] if args.seed else []), *small("--d", args.d), *batch],
              "train", lambda: _epoch_of(bigan) == args.epochs, parse=parse_bigan),
        Stage("scm", "train_audio_mnist_attribute_scm",
              [*zipf, "--steps", str(args.scm_steps), "--output-path", d], "train",
              exists(j(d, "audio-mnist-attribute-scm.tar")), shared=own, parse=parse_scm),
        Stage("clf", "train_audio_mnist_clf",
              [*zipf, "--attribute", "digit", "--epochs", str(args.clf_epochs), "--output-path", d,
               *small("--width", args.width), *batch], "train",
              exists(j(d, "audio-mnist-digit-clf.tar")), shared=own, parse=parse_per_epoch),
    ]
    if not args.no_vae:
        out.append(Stage("vae", "train_audio_mnist_vae",
                         [*zipf, "--steps", str(args.vae_epochs), "--checkpoint-every",
                          str(BUDGETS["checkpoint_every"]), "--output-path", d, "--resume",
                          *small("--d", args.d), *batch], "train",
                         lambda: _epoch_of(j(d, "audio-mnist-vae.tar")) == args.vae_epochs, shared=own,
                         parse=parse_per_epoch))
    rounds = ["--mc-rounds", str(BUDGETS["mc_rounds"])]
    out.append(Stage("bigan_score", "audiomnist_bigan_score",
                     [*zipf, "--model-dir", d, *rounds, *(["--image-model", bigan] if own else [])], "score",
                     parse=parse_score))
    if not args.no_vae:
        out.append(Stage("vae_score", "audiomnist_vae_score", [*zipf, "--model-dir", d, *rounds], "score",
                         parse=parse_score))
    out.append(Stage("generator_score", "audiomnist_generator_score",
                     ["--model-dir", d, *rounds, "--n", str(args.gen_n), *(["-m", bigan] if own else [])],
                     "score", parse=parse_score))
    if not args.no_vae:
        out.append(Stage("vae_generator_score", "audiomnist_vae_generator_score",
                         ["--model-dir", d, *rounds, "--n", str(args.gen_n)], "score", parse=parse_score))
    if args.no_identity:
        return out
    bigan_flag = ["--bigan", bigan] if own else []
    return out + [
        Stage("subject_clf", "train_audio_mnist_clf",
              [*zipf, "--attribute", "subject", "--epochs", str(args.subject_clf_epochs), "--output-path", d,
               *small("--width", args.width), *batch], "train",
              exists(j(d, "audio-mnist-subject-clf.tar")), shared=own, parse=parse_per_epoch),
        Stage("cf_classifier_metric", "audiomnist_cf_classifier_metric",
              [*zipf, "--model-dir", d, "--vae", "audio-mnist-vae.tar", *bigan_flag], "score",
              parse=parse_identity),
        Stage("cf_eval", "audiomnist_cf_eval",
              [*zipf, "--model-dir", d, "--vae", "audio-mnist-vae.tar", "--out-dir", a, *bigan_flag], "score",
              parse=parse_ratios),
    ]


# Stages that encode a spectrogram (through fused_encoder on the card), and
# those that run the digit or subject classifier (its head through
# fused_dense): the generator scores draw z from the prior and encode
# nothing; the SCM touches no image.
ENCODING_STAGES = ("bigan", "bigan_score", "vae_score", "cf_classifier_metric", "cf_eval")
CLASSIFYING_STAGES = ("clf", "bigan_score", "vae_score", "generator_score", "vae_generator_score",
                      "subject_clf", "cf_classifier_metric")


def windows(epochs: List[List[float]]) -> Dict[str, Optional[List[float]]]:
    """Mean D(G(z)) and D(E(x)) over each of :data:`JAX_BF16_WINDOWS`'s
    windows, from the BiGAN stage's ``[epoch, D(G(z)), D(E(x)), steps/s]``
    rows; None for a window the run did not reach."""
    out = {}
    for lo, hi in JAX_BF16_WINDOWS:
        rows = [r for r in epochs if lo <= r[0] <= hi]
        out[f"{lo}-{hi}"] = ([sum(r[1] for r in rows) / len(rows), sum(r[2] for r in rows) / len(rows)]
                             if len(rows) == hi - lo + 1 else None)
    return out


def scores_of(entries: Dict) -> Dict:
    """The numbers :func:`compare` reads, from the stages' parsed output."""
    def printed(stage, label=None):
        p = entries.get(stage, {}).get("printed", {})
        return p.get(label) if label else (p or None)

    nll = printed("scm", "nll")
    val = printed("clf", "val_acc")
    return {
        "bigan_cf_digit_accuracy": printed("bigan_score", "digit cf accuracy"),
        "bigan_generated_accuracy": printed("generator_score", "generated digit accuracy"),
        "vae_cf_digit_accuracy": printed("vae_score", "vae digit cf accuracy"),
        "vae_generated_accuracy": printed("vae_generator_score", "vae generated digit accuracy"),
        "scm_accent_nll": nll[-1][1] if nll else None,
        "digit_clf_val_acc": val[-1] if val else None,
        "subject_identity": printed("cf_classifier_metric"),
        "mean_ratio": printed("cf_eval"),
        "windows": windows(printed("bigan", "epochs") or []),
    }


# -------------------------------------------------------------- compare


def reference_for(record: Dict):
    """(the JAX record, its bands) of the record's arm: the identity arm's
    when the record ran the identity stages in float32, else the bf16 arm's."""
    if record.get("identity") and record.get("dtype") != "bfloat16":
        return JAX_F32_IDENTITY, F32_IDENTITY_BANDS
    return JAX_BF16, BF16_BANDS


def _lookup(tree: Dict, key: str):
    for part in key.split("."):
        tree = tree.get(part) if isinstance(tree, dict) else None
    return tree


def compare(record: Dict, reference: Optional[Dict] = None, bands: Optional[Dict] = None) -> Dict:
    """Hold ``record["scores"]`` against the JAX record of its arm (or
    ``reference`` in ``bands``: ``{metric: ("±", width) or ("≥", floor)}``),
    and, where the reference has subject identities, the paper's split (the
    BiGAN's at least :data:`IDENTITY_SPLIT` times the VAE's). Returns
    ``{"ok", "rows": [{metric, port, jax, band, ok}], "missed": [metric],
    "windows": [...]}``; a missing number misses its band. The windows of
    D(G(z)) are reported beside JAX's and not gated: ``windows_held`` says
    whether the last three are within a factor of :data:`WINDOW_FACTOR`."""
    if reference is None:
        reference, bands = reference_for(record)
    s, rows = record["scores"], []
    for key, (kind, width) in bands.items():
        got, want = _lookup(s, key), _lookup(reference, key)
        ok = got is not None and (abs(got - want) <= width if kind == "±" else got >= width)
        rows.append({"metric": key, "port": got, "jax": want, "band": f"{kind}{width:g}", "ok": ok})
    if "subject_identity" in reference:
        ids = s.get("subject_identity") or {}
        held = ids.get("bigan") is not None and ids.get("vae") is not None and \
            ids["bigan"] >= IDENTITY_SPLIT * ids["vae"]
        rows.append({"metric": "bigan_identity_at_least_3x_vae", "port": held, "jax": True, "band": "holds",
                     "ok": held})
    port_windows = s.get("windows") or {}
    wins = []
    for (lo, hi), (dg, de) in JAX_BF16_WINDOWS.items():
        got = port_windows.get(f"{lo}-{hi}")
        wins.append({"epochs": f"{lo}-{hi}", "jax": [dg, de], "port": got,
                     "within": None if got is None else dg / WINDOW_FACTOR <= got[0] <= dg * WINDOW_FACTOR})
    missed = [r["metric"] for r in rows if not r["ok"]]
    return {"ok": not missed, "rows": rows, "missed": missed, "windows": wins,
            "windows_held": all(w["within"] for w in wins[1:])}


def with_shared(arm: Dict, default: Dict) -> Dict:
    """``arm`` with the entries of the stages it took over from the default
    arm's directory (``shared_from``) read from ``default``'s record, and its
    scores recomputed: a seed arm's SCM and classifiers are the default
    arm's."""
    entries = {k: dict(default["stages"][k], shared_from=v["shared_from"])
               if v.get("shared_from") and k in default["stages"] else v for k, v in arm["stages"].items()}
    return {**arm, "stages": entries, "scores": scores_of(entries)}


def report_line(path: str, record: Dict, records: List[Dict]) -> Dict:
    """``--report``'s line: ``compare`` of a record, a seed arm's with the
    shared stages of the first record when that is its default arm."""
    first = records[0]
    if record.get("seed") and first["dirs"]["arm"] == record["dirs"]["data"]:
        record = with_shared(record, first)
    return {"record": path, "scores": record["scores"], "compare": compare(record)}


# ------------------------------------------------------------------ run


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser.parse_args(argv)
    if args.report:
        return report(args.report, report_line)
    from ..device import resolve_device

    resolve_device(args.device)  # before the first stage: the card, unless the CPU is asked for
    d, a = data_dir(args), arm_dir(args)
    os.makedirs(d, exist_ok=True)
    os.makedirs(a, exist_ok=True)
    header = {
        "battery": "audio", "dtype": args.dtype or "float32", "init_std": args.init_std, "seed": args.seed,
        "epochs": args.epochs, "vae": not args.no_vae, "identity": not args.no_identity,
        "zip_path": args.zip_path, "budgets": {k: getattr(args, k, BUDGETS[k]) for k in BUDGETS},
        "small": {"d": args.d, "width": args.width, "batch_size": args.batch_size},
        "dirs": {"data": d, "arm": a},
    }
    run_battery(args, argv, stages(args), os.path.join(a, RECORD), header, lambda: own_model_files(args),
                scores_of, parser.error)
    return 0


if __name__ == "__main__":
    sys.exit(main())
