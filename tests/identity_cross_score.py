"""The AudioMNIST identity metric in both packages on the same files: the
JAX script ``audiomnist_cf_classifier_metric.py`` and the port's CLI
(``imagecfgen_torch.cli.audiomnist_cf_classifier_metric``, on the CPU) score
one model directory that the JAX package wrote, with the same random
latents, and every row's subject logits are compared.

    python tests/identity_cross_score.py MODEL_DIR --label jax_clf [--subject-clf FILE] [--vae audio-mnist-vae.tar]
        [--out imagecfgen_torch/tools/battery_records/identity-cross-score.json]
    python tests/identity_cross_score.py MODEL_DIR --init-vae [--d 64] [--seed 0]

``MODEL_DIR`` holds ``audio-mnist-bigan.tar`` (the BiGAN), the VAE file and
the 60-way subject classifier (``--subject-clf``, a path relative to
``MODEL_DIR`` or absolute), each in the JAX package's format. The JAX script
runs in this process as ``__main__`` (``runpy``), as
``tests/jax_cpu_battery.py`` runs scripts: JAX on the CPU in float32, the
transposed convs summed by phase (the script scans nothing, so its own jits
stay on). It draws each chunk's latents
with ``jax.random.normal``; they are captured as it draws them and handed,
row for row, to the port's ``digit_counterfactuals`` in place of its own
draws (a stand-in for ``torch.randn`` while that function runs, here, not a
flag of the CLI). Each package's subject logits are captured where its
classifier returns them (the JAX script's ``jnp.argmax`` of them, a forward
hook on the port's classifier). For each printed line (``bigan``, ``vae``,
``bigan_int``) the record holds both packages' hits and total, the rows
whose subjects the two name differently and how many of those are near
ties (top-two logits within 1e-4 in either package), and the smallest
top-two margin over all rows: ``tests/fault_verdicts.py``'s
``identity_scorer_verdict`` reads it. ``--label`` names the run in the
record (``jax_clf``, ``port_clf``). ``--init-vae`` writes the VAE file as
``train_audio_mnist_vae.py`` writes it, at its initialisation.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import runpy
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RECORD = os.path.join(REPO, "imagecfgen_torch", "tools", "battery_records", "identity-cross-score.json")
N_SUBJECTS, LATENT = 60, 512
NEAR_TIE = 1e-4


def margin(logits):
    """Each row's top logit less its second."""
    import numpy as np

    top2 = np.sort(np.asarray(logits, np.float64), axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def run_jax(model_dir: str, argv) -> dict:
    """The JAX script on ``argv``: what it printed, its latent draws and
    its subject logits, in the order it made them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax_cpu_battery import phase_conv_transpose2d

    from imagecfgen_tpu.cli import common as jcommon
    from imagecfgen_tpu.models import layers as jlayers

    draws, logits = [], []
    normal, argmax = jax.random.normal, jnp.argmax

    def drawn(key, shape=(), *args, **kwargs):
        z = normal(key, shape, *args, **kwargs)
        if tuple(shape)[1:] == (1, 1, LATENT):
            draws.append(np.asarray(z))
        return z

    def seen(a, *args, **kwargs):
        if not isinstance(a, jax.core.Tracer) and a.ndim == 2 and a.shape[1] == N_SUBJECTS:
            logits.append(np.asarray(a))
        return argmax(a, *args, **kwargs)

    saved = (jcommon.clean_exit, jcommon.install_cli_excepthook, jlayers.conv_transpose2d, sys.argv)
    out = io.StringIO()
    jax.random.normal, jnp.argmax = drawn, seen
    jcommon.clean_exit, jcommon.install_cli_excepthook = (lambda code=0: None), (lambda: None)
    jlayers.conv_transpose2d = phase_conv_transpose2d
    sys.argv = ["audiomnist_cf_classifier_metric.py", "--model-dir", model_dir, *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "audiomnist_cf_classifier_metric.py"), run_name="__main__")
    finally:
        jax.random.normal, jnp.argmax = normal, argmax
        jcommon.clean_exit, jcommon.install_cli_excepthook, jlayers.conv_transpose2d, sys.argv = saved
    return {"printed": out.getvalue(), "draws": draws, "logits": logits}


def run_port(model_dir: str, argv, draws) -> dict:
    """The port's CLI on ``argv`` (``--device cpu``) with the JAX script's
    ``draws`` as its latents: what it printed and its subject logits."""
    import numpy as np
    import torch

    from imagecfgen_torch.cli import audio_common as taudio
    from imagecfgen_torch.cli import audiomnist_cf_classifier_metric as metric
    from imagecfgen_torch.cli import audiomnist_cf_eval as cf_eval

    queue, logits = list(draws), []
    counterfactuals, load_classifier, randn = cf_eval.digit_counterfactuals, taudio.load_audio_classifier, torch.randn

    def injected(shape, *args, generator=None, **kwargs):
        z = queue.pop(0)
        if tuple(shape)[1:] != z.shape[1:] or shape[0] > z.shape[0]:
            raise ValueError(f"a draw of {tuple(shape)} where the JAX script drew {z.shape}")
        return torch.from_numpy(np.ascontiguousarray(z[:shape[0]]))

    def with_draws(*args, **kwargs):
        torch.randn = injected
        try:
            return counterfactuals(*args, **kwargs)
        finally:
            torch.randn = randn

    def hooked(*args, **kwargs):
        model, stats, meta = load_classifier(*args, **kwargs)
        model.register_forward_hook(lambda m, i, o: logits.append(o.detach().cpu().numpy()))
        return model, stats, meta

    out = io.StringIO()
    cf_eval.digit_counterfactuals, taudio.load_audio_classifier = with_draws, hooked
    try:
        with contextlib.redirect_stdout(out):
            code = metric.main(["--model-dir", model_dir, *argv, "--device", "cpu"])
    finally:
        cf_eval.digit_counterfactuals, taudio.load_audio_classifier = counterfactuals, load_classifier
    if code or queue:
        raise RuntimeError(f"the port's CLI exited with {code}, {len(queue)} JAX draws left")
    return {"printed": out.getvalue(), "logits": logits}


def printed_lines(text: str) -> dict:
    import re

    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\w+): subject-identity accuracy after digit CF = ([0-9.]+)$", text, re.M)}


def cross_score(model_dir: str, subject_clf: str, vae: str = "audio-mnist-vae.tar", log=print) -> dict:
    """Both packages on ``model_dir``; returns the run's record entry."""
    import numpy as np

    from imagecfgen_tpu.cli import audio_common as jaudio

    argv = ["--vae", vae, "--subject-clf", subject_clf]
    t0 = time.perf_counter()
    jax_run = run_jax(model_dir, argv)
    t1 = time.perf_counter()
    port_run = run_port(model_dir, argv, jax_run["draws"])
    t2 = time.perf_counter()
    log(f"JAX {t1 - t0:.0f} s, the port {t2 - t1:.0f} s")

    # the rows each chunk scores, as both scripts walk them
    data = jaudio.load_audio_dataset(None)
    _, attrs, idx = data.all_spectrograms(excluded_runs=data.validation_excluded_runs)
    subjects, digits = data.raw["subject"][idx] - 1, attrs["digit"].argmax(axis=1)
    chunks = [rows[i:i + 256] for d in range(10) for rows in [np.nonzero(digits != d)[0]]
              for i in range(0, len(rows), 256)]
    # per chunk the JAX script classifies bigan, bigan_int, vae; the port bigan, vae, bigan_int
    order = {"jax": ("bigan", "bigan_int", "vae"), "port": ("bigan", "vae", "bigan_int")}
    per = {pkg: {m: [] for m in order[pkg]} for pkg in order}
    for pkg, got in (("jax", jax_run["logits"]), ("port", port_run["logits"])):
        if len(got) != len(chunks) * 3:
            raise RuntimeError(f"{pkg}: {len(got)} classifier calls for {len(chunks)} chunks of three lines")
        for c, rows in enumerate(chunks):
            for k, m in enumerate(order[pkg]):
                per[pkg][m].append(got[3 * c + k][:len(rows)])
    subj = np.concatenate([subjects[rows] for rows in chunks])
    lines, smallest = {}, float("inf")
    for m in ("bigan", "vae", "bigan_int"):
        lj, lp = np.concatenate(per["jax"][m]), np.concatenate(per["port"][m])
        pj, pp = lj.argmax(axis=1), lp.argmax(axis=1)
        near = np.minimum(margin(lj), margin(lp)) <= NEAR_TIE
        differ = pj != pp
        smallest = min(smallest, float(margin(lj).min()), float(margin(lp).min()))
        lines[m] = {"jax": [int((pj == subj).sum()), len(subj)], "port": [int((pp == subj).sum()), len(subj)],
                    "disagree": int(differ.sum()), "near_ties": int((differ & near).sum()),
                    "max_logit_gap": float(np.abs(lj.astype(np.float64) - lp).max())}
    printed = {"jax": printed_lines(jax_run["printed"]), "port": printed_lines(port_run["printed"])}
    return {"model_dir": model_dir, "subject_clf": subject_clf, "vae": vae, "lines": lines,
            "printed": printed, "min_margin": smallest, "seconds": {"jax": t1 - t0, "port": t2 - t1}}


def init_vae(path: str, d: int = 64, seed: int = 0) -> None:
    """``train_audio_mnist_vae.py``'s file of a VAE at its initialisation
    (``--seed``), before any epoch."""
    import jax
    import numpy as np

    from imagecfgen_tpu.cli.audio_common import load_audio_dataset, prepare_training_arrays
    from imagecfgen_tpu.core.checkpoint import save_checkpoint
    from imagecfgen_tpu.models.vae import ConditionalVAE, audio_mnist_vae_config
    from imagecfgen_tpu.train.vae_trainer import VAETrainConfig, VAETrainer

    _, _, stats = prepare_training_arrays(load_audio_dataset(None))
    state = VAETrainer(ConditionalVAE(audio_mnist_vae_config(d=d)), VAETrainConfig()).init_state(
        jax.random.PRNGKey(seed))
    save_checkpoint(path, {"params": state.params, "opt": state.opt, "step": state.step, "rng": state.rng,
                           "spect_mean": np.asarray(stats.mean), "spect_std": np.asarray(stats.std)},
                    meta={"kind": "vae-audio-mnist", "epoch": 0, "d": d, "carries_rng": True})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("--label", help="the run's name in the record: jax_clf or port_clf")
    p.add_argument("--init-vae", action="store_true", help="write MODEL_DIR/--vae at its initialisation, then stop")
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--subject-clf", default="audio-mnist-subject-clf.tar")
    p.add_argument("--vae", default="audio-mnist-vae.tar")
    p.add_argument("--out", default=RECORD)
    args = p.parse_args(argv)
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path[:0] = [REPO, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.init_vae:
        init_vae(os.path.join(args.model_dir, args.vae), args.d, args.seed)
        return 0
    if not args.label:
        p.error("--label names the run")
    run = cross_score(args.model_dir, args.subject_clf, args.vae, log=lambda s: print(s, flush=True))
    print(json.dumps(run["lines"]), flush=True)
    record = {"runs": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
    record.update({"metric": "audiomnist_cf_classifier_metric", "platform": "cpu", "cpu_count": os.cpu_count()})
    record["runs"][args.label] = run
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
