"""The port's explainer, oracle and fine-tuning CLIs (``python -m
imagecfgen_torch.cli.<name>``) on the CPU, at 16 rows: a 16-row training and
a 16-row test split of synthetic glyphs with ground-truth attributes, narrow
BiGAN, VAE, classifier and oracle configs (every width an eighth, latent 32)
patched in where the CLIs build them, the explainers at 5 steps. This file
holds the CLIs without a card, the oracles and the metrics CSV, and the
``trained`` fixture and helpers that ``test_torch_cli_explain_scores.py``
(the parsers, the oracle scores), ``test_torch_cli_explain_strips.py``
(``--help``, the strips, the fine-tune, the SHAP estimator) and
``test_torch_cli_explain_arrays.py`` (the matrix, the SHAP arrays) share,
so that each runs on a worker of its own; the artifacts are trained once a
session.

- each parser takes every option string of its JAX script's parser, with the
  same defaults, plus ``--device`` (``show_cf_matrix`` reads a pickle and
  takes none); ``--help`` runs with no card and with matplotlib, PIL, pandas
  and tqdm unimportable; without ``--device cpu`` and with no card every CLI
  that touches a tensor raises before it runs;
- every CLI runs on the trained artifacts: the oracles load back, the PNGs
  decode to their sizes, the CSV headers equal the columns the JAX scripts
  write (built here by the JAX scripts' own loops), NaN fields are empty,
  the matrix pickle has the JAX script's keys and ``show_cf_matrix`` prints
  what the JAX script prints for the same pickle, the fine-tuned checkpoint
  moves E only and ``mnist_reconstructions`` renders it, the SHAP arrays
  have shape (N, 10, 3);
- the SHAP estimator with the JAX script's draws injected (its background
  indices, t and z under the keys it derives) equals the JAX script's
  ``expected_gradients`` (``jax.jacrev`` over the z-averaged softmax) within
  1e-4 relative plus 1e-4 of the largest value, on narrow models carried
  across by ``core.convert``.
"""
import contextlib
import csv
import dataclasses
import fcntl
import importlib
import io
import os
import re
from pathlib import Path

import pytest
import torch
from test_torch_cli_mnist import write_dataset
from test_torch_train_layers import narrow_config, narrow_plan

from imagecfgen_torch.cli.common import load_classifier, load_mnist_training_data
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import vae as tvae

REPO = Path(__file__).resolve().parents[1]
TENSOR_CLIS = ("train_morphomnist_oracles", "mnist_cf_explain", "mnist_cf_comparisons", "make_mnist_cf_matrix",
               "mnist_oracle_scores", "morphomnist_cf_metrics", "finetune_mnist_bigan", "mnist_reconstructions",
               "morphomnist_attribute_shap")
CLIS = TENSOR_CLIS + ("show_cf_matrix",)
N, BATCH, STEPS = 16, 8, 5


@contextlib.contextmanager
def narrow_models():
    cfg = narrow_config(tbigan, "mnist")
    vcfg = dataclasses.replace(cfg, init_std=1e-4)
    configs = {}
    for name in ("mnist_classifier_config", "mnist_oracle_config"):
        full = getattr(tclf, name)()
        configs[name] = dataclasses.replace(full, plan=narrow_plan(full.plan, 8, keep_last=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbigan, "mnist_bigan_config", lambda: cfg)
        mp.setattr(tvae, "mnist_vae_config", lambda: vcfg)
        for name, c in configs.items():
            mp.setattr(tclf, name, lambda c=c: c)
        yield


def run(name: str, *argv, device: bool = True) -> str:
    """One CLI through its ``main`` (on the CPU, narrow models); returns
    what it printed."""
    out = io.StringIO()
    argv = [*map(str, argv), *(("--device", "cpu") if device else ())]
    with narrow_models(), contextlib.redirect_stdout(out):
        code = importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv)
    assert code == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The data and models every CLI run reads, made once a test session:
    the first of this file and the three beside it to ask makes them, under
    a lock, in a directory that the session's workers share (their base
    temporary directories' parent under pytest-xdist); the others wait for
    it and read them. The tests only read these files."""
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "explain-cli"
    root.mkdir(exist_ok=True)
    data, models, log = root / "data", root / "models", root / "oracles.log"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not log.exists():
            write_dataset(data, N, N, 3)
            run("train_mnist_clf", "--data-dir", data, "--output-path", models, "--epochs", 2, "--batch-size",
                BATCH)
            run("train_mnist_image_scm", "--data-dir", data, "--output-path", models, "--batch-size", BATCH,
                "--steps", 1)
            run("train_mnist_vae", "--data-dir", data, "--output-path", models, "--steps", 1, "--batch-size",
                BATCH)
            for cls in ("-1", "3"):
                run("train_morphomnist_ae", "--data-dir", data, "--output-path", models, "--epochs", 1,
                    "--batch-size", BATCH, "--cls", cls)
            oracles = run("train_morphomnist_oracles", "--data-dir", data, "--output-path", models, "--epochs",
                          1, "--batch-size", BATCH)
            (root / "oracles.tmp").write_text(oracles)
            os.replace(root / "oracles.tmp", log)
    return data, models, log.read_text()


# ------------------------------------------------------------ the CLIs without a card


@pytest.mark.parametrize("name", TENSOR_CLIS)
def test_cli_without_a_card_raises_before_it_runs(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--data-dir", str(tmp_path / "none")]
    if name == "train_morphomnist_oracles":
        argv += ["--output-path", str(tmp_path / "out")]
    elif name not in ("finetune_mnist_bigan", "mnist_reconstructions"):
        argv += ["--model-dir", str(tmp_path / "none")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------ the runs


def test_oracles_write_ten_checkpoints_that_load_back(trained):
    data, models, log = trained
    x = torch.from_numpy(load_mnist_training_data(str(data), "test")[0][:4])
    for d in range(10):
        assert re.search(rf"oracle {d}: train acc [0-9.]+ -> ", log)
        path = str(models / f"oracle-{d}.tar")
        assert checkpoint_format(path) == "torch"
        with narrow_models(), torch.no_grad():
            logits = load_classifier(path, tclf.mnist_oracle_config(), "cpu")(x)
        assert logits.shape == (4, 1) and torch.isfinite(logits).all()


def jax_oracle_columns():
    """The columns ``mnist_oracle_scores.py`` writes, by its own loops."""
    row = {"digit": 0, "target_class": 0}
    for name in ("bigan", "bigan_agnostic", "cf", "pn"):
        row.update({f"{name}_label": 0, f"{name}_oracle_agree": 0, f"{name}_js": 0})
        row.update({f"{name}_os_{j}": 0 for j in range(10)})
    return list(row)


def jax_metrics_columns(vae: bool):
    """The columns ``morphomnist_cf_metrics.py`` writes, by its own loops."""
    row = {"digit": 0, "target_class": 0, "thickness": 0, "intensity": 0, "slant": 0}
    names = ("bigan", "bigan_agnostic") + (("vae", "vae_agnostic") if vae else ()) + ("cf", "pn")
    for name in names:
        row.update({f"{name}_label": 0, f"l1_{name}": 0, f"o_rec_{name}": 0, f"t_rec_{name}": 0,
                    f"all_rec_{name}": 0})
    return list(row)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_cf_metrics_csv_has_the_jax_columns(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "metrics.csv"
    log = run("morphomnist_cf_metrics", "--data-dir", data, "--model-dir", models, "--limit", N,
              "--steps", STEPS, "--output", out)
    assert "omnixai unavailable" in log and f"{N}/{N}" in log
    header, rows = read_csv(out)
    assert header == jax_metrics_columns(vae=True) and len(rows) == N
    for r in rows:
        d = dict(zip(header, r))
        for name in ("bigan", "vae_agnostic", "pn"):
            assert float(d[f"l1_{name}"]) > 0
            # ae-3 and ae-all exist: a column is a number exactly when its digit's AE is there
            assert (d[f"o_rec_{name}"] == "") == (d["digit"] != "3")
            assert (d[f"t_rec_{name}"] == "") == (d[f"{name}_label"] != "3")
            assert (d[f"all_rec_{name}"] == "") == (d[f"{name}_label"] != "3")

    # without the VAE: its columns go, as in the JAX script
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in ("mnist-bigan.tar", "mnist_clf.tar"):
        (bare / f).symlink_to(models / f)
    run("morphomnist_cf_metrics", "--data-dir", data, "--model-dir", bare, "--ae-dir", models,
        "--limit", 2, "--steps", 1, "--output", tmp_path / "bare.csv")
    assert read_csv(tmp_path / "bare.csv")[0] == jax_metrics_columns(vae=False)
