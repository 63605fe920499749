"""The port's explainer, oracle and fine-tuning CLIs (``python -m
imagecfgen_torch.cli.<name>``) on the CPU, at 16 rows: a 16-row training and
a 16-row test split of synthetic glyphs with ground-truth attributes, narrow
BiGAN, VAE, classifier and oracle configs (every width an eighth, latent 32)
patched in where the CLIs build them, the explainers at 5 steps.

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
import importlib
import io
import json
import os
import pickle
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli_mnist import write_dataset
from test_torch_explain import make_models
from test_torch_train_layers import narrow_config, narrow_plan

from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.cli.common import (
    bigan_from_state,
    load_bigan,
    load_classifier,
    load_mnist_training_data,
    read_png,
)
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
    root = tmp_path_factory.mktemp("explain-cli")
    data, models = root / "data", root / "models"
    write_dataset(data, N, N, 3)
    run("train_mnist_clf", "--data-dir", data, "--output-path", models, "--epochs", 2, "--batch-size", BATCH)
    run("train_mnist_image_scm", "--data-dir", data, "--output-path", models, "--batch-size", BATCH,
        "--steps", 1)
    run("train_mnist_vae", "--data-dir", data, "--output-path", models, "--steps", 1, "--batch-size", BATCH)
    for cls in ("-1", "3"):
        run("train_morphomnist_ae", "--data-dir", data, "--output-path", models, "--epochs", 1,
            "--batch-size", BATCH, "--cls", cls)
    oracles = run("train_morphomnist_oracles", "--data-dir", data, "--output-path", models, "--epochs", 1,
                  "--batch-size", BATCH)
    return data, models, oracles


# ------------------------------------------------------------ the parsers


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x")["parser"]
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    extra = {"--device"} if name in TENSOR_CLIS else set()
    assert _options(tparser) == _options(jparser) | extra
    port = {a.dest: a for a in tparser._actions}
    for a in jparser._actions:
        t = port[a.dest]
        assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
            a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest
    if extra:
        assert tparser.parse_args([]).device == "cuda"


@pytest.fixture(scope="module")
def help_texts():
    """Every new CLI's ``--help``, in one process with no card and with
    matplotlib, PIL, pandas and tqdm blocked."""
    code = (
        "import contextlib, importlib.abc, io, json, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'PIL', 'pandas', 'tqdm'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "out = {}\n"
        f"for name in {list(CLIS)!r}:\n"
        "    buf = io.StringIO()\n"
        "    sys.argv = [name, '--help']\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            runpy.run_module('imagecfgen_torch.cli.' + name, run_name='__main__')\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (name, e.code)\n"
        "    out[name] = buf.getvalue()\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CLIS)
def test_help_needs_no_card_and_no_missing_package(name, help_texts):
    text = help_texts[name]
    assert text.startswith("usage:")
    assert ("--device" in text) == (name in TENSOR_CLIS)


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


def test_cf_explain_and_comparisons_write_their_strips(trained, tmp_path):
    data, models, _ = trained
    log = run("mnist_cf_explain", "--data-dir", data, "--model-dir", models, "--steps", STEPS,
              "--sample-points", 12, "--output", tmp_path / "explain.png")
    assert re.search(r"best mixture weight: (nan|[0-9.]+)", log)
    h, w = read_png(str(tmp_path / "explain.png")).shape
    assert h == 3 * 28 and w in (28 * k for k in range(1, 5))
    run("mnist_cf_comparisons", "--data-dir", data, "--model-dir", models, "--n-images", 3,
        "--steps", STEPS, "--output", tmp_path / "comparisons.png")
    assert read_png(str(tmp_path / "comparisons.png")).shape == (5 * 28, 3 * 28)


def test_matrix_pickle_and_its_printout_match_the_jax_script(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "matrix.pkl"
    run("make_mnist_cf_matrix", "--data-dir", data, "--model-dir", models, "--per-digit", 1,
        "--sample-points", 10, "--metric", "ssim", "--output", out)
    with open(out, "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == {"matrix", "counts", "metric"} and saved["metric"] == "ssim"
    assert saved["matrix"].shape == saved["counts"].shape == (10, 10)
    assert np.isnan(np.diag(saved["matrix"])).all() and (np.diag(saved["counts"]) == 0).all()
    assert (np.isnan(saved["matrix"]) == (saved["counts"] == 0)).all()

    # the same printout as the JAX script, for this pickle and one with a NaN-free row
    other = tmp_path / "other.pkl"
    with open(other, "wb") as f:
        m = np.arange(100, dtype=float).reshape(10, 10) / 7.0
        m[2, 5] = np.nan
        pickle.dump({"matrix": m, "counts": np.ones((10, 10)), "metric": "mixture"}, f)
    for path, metric in ((out, "ssim"), (other, None)):
        flags = ["--matrix", str(path)] + (["--metric", metric] if metric else [])
        want = subprocess.run([sys.executable, str(REPO / "show_cf_matrix.py"), *flags], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert want.returncode == 0, want.stderr
        assert run("show_cf_matrix", *flags, device=False) == want.stdout
    with pytest.raises(SystemExit, match="was built with metric='ssim'"):
        run("show_cf_matrix", "--matrix", out, "--metric", "mse", device=False)


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


def test_oracle_scores_csv_has_the_jax_columns(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "scores.csv"
    log = run("mnist_oracle_scores", "--data-dir", data, "--model-dir", models, "--limit", N,
              "--steps", STEPS, "--output", out)
    header, rows = read_csv(out)
    assert header == jax_oracle_columns() and len(rows) == N
    for name in ("bigan", "bigan_agnostic", "cf", "pn"):
        rate = float(re.search(rf"^{name}_oracle_agree: ([0-9.]+)$", log, re.M).group(1))
        assert 0.0 <= rate <= 1.0
    for r in rows:
        d = dict(zip(header, r))
        assert int(d["target_class"]) != int(d["digit"])
        for name in ("bigan", "cf"):
            assert -1e-6 <= float(d[f"{name}_js"]) <= np.log(2) + 1e-6  # float32 rounding
            assert all(0.0 <= float(d[f"{name}_os_{j}"]) <= 1.0 for j in range(10))


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


def test_finetune_moves_e_only_and_reconstructions_render_it(trained, tmp_path, monkeypatch):
    data, models, _ = trained
    monkeypatch.chdir(tmp_path)
    src = str(models / "mnist-bigan.tar")
    for metric in ("mse", "ssim"):
        log = run("finetune_mnist_bigan", "--data-dir", data, "--model-file", src, "--steps", 2,
                  "--metric", metric, "--lr", 1e-3, "--batch-size", BATCH)
        assert len(re.findall(rf"epoch [12]/2: {metric}=[0-9.]+ latent=[0-9.]+ \([0-9.]+ steps/s\)", log)) == 2
        out = tmp_path / f"mnist-bigan-finetuned-{metric}.tar"
        assert checkpoint_format(str(out)) == "torch"
        before, scaler0, _ = load_bigan(src, "cpu")
        after, scaler1, meta = load_bigan(str(out), "cpu")
        assert meta["finetuned"] == metric and meta["kind"] == "bigan"
        assert scaler1.state_dict() == scaler0.state_dict()
        assert all(not torch.equal(after["E"][k], v) for k, v in before["E"].items())
        for part in ("G", "D"):
            assert all(torch.equal(after[part][k], v) for k, v in before[part].items())
        assert after["step"] == before["step"] and after["opt_eg"]["count"] == before["opt_eg"]["count"]
        with narrow_models():
            engine = CounterfactualEngine(bigan_from_state(after, tbigan.mnist_bigan_config(), "cpu"),
                                          None, scaler1, "cpu")
        x, attrs, _ = load_mnist_training_data(str(data), "test")
        assert engine.reconstruct(x[:4], {k: v[:4] for k, v in attrs.items()}).shape == (4, 28, 28, 1)
    log = run("mnist_reconstructions", "--data-dir", data, "--model-files", src,
              "mnist-bigan-finetuned-mse.tar", "mnist-bigan-finetuned-ssim.tar", "--n-images", 6,
              "--output", "recon.png")
    assert read_png(str(tmp_path / "recon.png")).shape == (4 * 28, 6 * 28)
    assert "row 3: mnist-bigan-finetuned-mse" in log


def test_shap_writes_both_models_arrays(trained, tmp_path, monkeypatch):
    data, models, _ = trained
    monkeypatch.chdir(tmp_path)
    args = ("--data-dir", data, "--model-dir", models, "--limit", 3, "--n-background", 8, "--n-mc", 2,
            "--n-steps", 4)
    log = run("morphomnist_attribute_shap", *args)
    first = {}
    for name in ("bigan", "vae"):
        assert f"saved {name}_attribute_shap.npy (mean |shap|: " in log
        first[name] = np.load(tmp_path / f"{name}_attribute_shap.npy")
        assert first[name].shape == (3, 10, 3) and np.isfinite(first[name]).all()
    assert np.abs(first["bigan"]).max() > 0
    run("morphomnist_attribute_shap", *args)  # the draws come from a seeded generator
    np.testing.assert_array_equal(np.load(tmp_path / "bigan_attribute_shap.npy"), first["bigan"])


def test_shap_estimator_matches_the_jax_script():
    from imagecfgen_torch.cli.morphomnist_attribute_shap import expected_gradients, unpack

    jfns, tfns, _, _, _ = make_models(seed=4)
    _, jG, jC = jfns
    _, tG, tC = tfns
    rng = np.random.default_rng(0)
    bg = rng.uniform(-1, 1, (8, 13)).astype(np.float32)
    bg[:, :10] = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    a13 = bg[3:4] * 0.5 + 0.1
    n_steps, n_mc = 4, 3

    # the JAX script's expected_gradients, its draws kept
    key = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(key, 3)
    bidx = jax.random.randint(k1, (n_steps,), 0, 8)
    ts = jax.random.uniform(k2, (n_steps,))
    step_keys = jax.random.split(k3, n_steps)

    def junpack(a):
        return {"digit": a[:, :10], "thickness": a[:, 10], "intensity": a[:, 11], "slant": a[:, 12]}

    def class_probs(a, k):
        def one(kk):
            z = jax.random.normal(kk, (a.shape[0], 1, 1, 32))
            return jax.nn.softmax(jC(jG(z, junpack(a))), axis=1)
        return jax.vmap(one)(jax.random.split(k, n_mc)).mean(axis=0)

    def one_step(b_i, t, k):
        base = jnp.asarray(bg)[b_i][None]
        point = base + t * (jnp.asarray(a13) - base)
        grad = jax.jacrev(lambda a: class_probs(a, k).sum(axis=0))(point)
        return grad[:, 0, :] * (jnp.asarray(a13) - base)[0]

    want = np.asarray(jax.jit(jax.vmap(one_step))(bidx, ts, step_keys).mean(axis=0))
    z = np.stack([np.stack([np.asarray(jax.random.normal(kk, (1, 1, 1, 32)))[0]
                            for kk in jax.random.split(k, n_mc)]) for k in step_keys])
    got = expected_gradients(tG, tC, torch.from_numpy(a13), torch.from_numpy(bg),
                             torch.from_numpy(np.array(bidx)).long(), torch.from_numpy(np.array(ts)),
                             torch.from_numpy(z)).detach().numpy()
    assert got.shape == want.shape == (10, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert np.abs(want[:, 10:]).min() > 0
    assert set(unpack(torch.zeros(2, 13))) == {"digit", "thickness", "intensity", "slant"}
