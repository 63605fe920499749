"""The port's seven MNIST CLIs (``python -m imagecfgen_torch.cli.<name>``) on
the CPU, at a small size: narrow model configs (every width an eighth,
latent 32) patched in where the CLIs build them, a 128-row training split
and a 64-row test split of synthetic glyphs with ground-truth attributes.

- each parser takes every option string of its JAX script's parser, with the
  same defaults, plus ``--device``;
- ``--help`` runs with no card and with matplotlib and PIL unimportable, and
  without ``--device cpu`` and with no card every CLI raises before it runs;
- the pipeline runs end to end: both trainers, the attribute SCM, the
  autoencoder, a resumed run (bit for bit), ``--throughput`` (one D update a
  step), and the three serving CLIs on those artifacts;
- a model directory the JAX package's CLIs wrote loads into the port: its
  ``reconstruct`` matches the JAX engine's within 1e-4·max(1, max|x|) (the
  ``test_torch_cf_engine.py`` images' tolerance, relative to their range) and
  the classifier's logits likewise; the serving CLIs score it and the
  trainer resumes it;
- the PNG writer's grid decodes back to its rows.
"""
import contextlib
import dataclasses
import importlib
import io
import os
import re
import runpy
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_clf_trainer import redraw
from test_torch_gan_trainer import jax_state
from test_torch_train_layers import narrow_config, narrow_plan

from imagecfgen_tpu.cf.engine import CounterfactualEngine as JEngine
from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_SPEC
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.data import mnist as jmnist
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.cli.common import (
    bigan_from_state,
    load_attribute_scm,
    load_bigan,
    load_classifier,
    load_mnist_training_data,
    read_png,
    save_grid_png,
)
from imagecfgen_torch.core.attributes import one_hot, pack_mnist_attrs
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.data.synthetic_digits import synthetic_digits
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf

REPO = Path(__file__).resolve().parents[1]
CLIS = ("train_mnist_attribute_scm", "train_mnist_clf", "train_mnist_image_scm",
        "mnist_gan_counterfactuals", "mnist_bigan_score", "mnist_generator_score",
        "train_morphomnist_ae")
N_TRAIN, N_TEST, BATCH = 128, 64, 32


def write_dataset(path: Path, n_train: int, n_test: int, seed: int) -> None:
    """Glyphs and attributes from the ground-truth SCM's closed form:
    t = Gamma(10, rate 5) + 0.5, i = 191·sigmoid(0.5·e + 2t − 5) + 64,
    s = π·N(0, 0.1)."""
    x, labels = synthetic_digits(n_train + n_test, seed)
    rng = np.random.default_rng(seed + 1)
    n = len(x)
    t = rng.gamma(10, 1 / 5, n) + 0.5
    i = 191 / (1 + np.exp(-(0.5 * rng.normal(0, 1, n) + 2 * t - 5))) + 64
    s = np.pi * rng.normal(0, 0.1, n)
    a = pack_mnist_attrs({"digit": one_hot(labels, 10), "thickness": t, "intensity": i, "slant": s})
    path.mkdir(parents=True, exist_ok=True)
    for split, rows in (("train", slice(0, n_train)), ("test", slice(n_train, n))):
        np.save(path / f"mnist-x-{split}.npy", np.round(x[rows]).astype(np.uint8))
        np.save(path / f"mnist-a-{split}.npy", a[rows])


def run(name: str, *argv) -> str:
    """One CLI through its ``main`` on the CPU; returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = importlib.import_module(f"imagecfgen_torch.cli.{name}").main(
            [*map(str, argv), "--device", "cpu"])
    assert code == 0
    return out.getvalue()


def score(text: str, what: str) -> float:
    value = float(re.search(rf"{what}: ([0-9.]+)", text).group(1))
    assert 0.0 <= value <= 1.0
    return value


@pytest.fixture(scope="module")
def narrow():
    """The narrow BiGAN and classifier configs, patched in where the CLIs
    build theirs."""
    cfg = narrow_config(types.SimpleNamespace(mnist_bigan_config=tbigan.mnist_bigan_config), "mnist")
    full = tclf.mnist_classifier_config()
    ccfg = dataclasses.replace(full, plan=narrow_plan(full.plan, 8, keep_last=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbigan, "mnist_bigan_config", lambda: cfg)
        mp.setattr(tclf, "mnist_classifier_config", lambda: ccfg)
        yield cfg, ccfg


def gan_args(data, out, *extra):
    return ("--data-dir", data, "--output-path", out, "--batch-size", BATCH,
            "--checkpoint-every", 1, "--save-images-every", 1, *extra)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, narrow):
    root = tmp_path_factory.mktemp("cli")
    data, models = root / "data", root / "models"
    write_dataset(data, N_TRAIN, N_TEST, 0)
    logs = {
        "scm": run("train_mnist_attribute_scm", "--data-dir", data, "--output-path", models,
                   "--steps", 3, "--batch-size", 64),
        "clf": run("train_mnist_clf", "--data-dir", data, "--output-path", models, "--epochs", 5,
                   "--batch-size", BATCH),
        "gan": run("train_mnist_image_scm", *gan_args(data, models, "--steps", 2)),
        "ae": run("train_morphomnist_ae", "--data-dir", data, "--output-path", models,
                  "--epochs", 1, "--batch-size", BATCH, "--latent-dim", 8),
    }
    return data, models, logs


# ------------------------------------------------------------ the parsers


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x")["parser"]
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    assert _options(tparser) == _options(jparser) | {"--device"}
    port = {a.dest: a for a in tparser._actions}
    for a in jparser._actions:
        t = port[a.dest]
        assert (t.default, t.nargs, t.type, t.option_strings) == (
            a.default, a.nargs, a.type, a.option_strings), a.dest
    assert tparser.parse_args([]).device == "cuda"
    assert tparser.parse_args(["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("name", CLIS)
def test_help_needs_no_card_and_no_matplotlib(name):
    code = (
        "import importlib.abc, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.argv = ['{name}', '--help']\n"
        f"runpy.run_module('imagecfgen_torch.cli.{name}', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:") and "--device" in out.stdout


@pytest.mark.parametrize("name", CLIS)
def test_cli_without_a_card_raises_before_it_runs(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data-dir", str(tmp_path / "none")]
    if name.startswith("train"):
        argv += ["--output-path", str(tmp_path / "out")]
    else:
        argv += ["--model-dir", str(tmp_path / "none")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv)
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------ the pipeline


def test_training_clis_write_artifacts_that_load_back(trained, narrow):
    data, models, logs = trained
    cfg, ccfg = narrow
    steps = 2 * (N_TRAIN // BATCH)
    state, scaler, meta = load_bigan(str(models / "mnist-bigan.tar"), "cpu")
    assert checkpoint_format(str(models / "mnist-bigan.tar")) == "torch"
    assert meta == {"kind": "bigan", "carries_rng": True, "epoch": 2}
    assert state["step"] == steps and state["opt_d"]["count"] == 2 * steps
    assert state["opt_eg"]["count"] == -(-steps // 3)
    _, attrs, want = load_mnist_training_data(str(data), "train")
    for part in ("mins", "maxs"):
        assert scaler.state_dict()[part] == want.state_dict()[part]
    assert len(re.findall(r"D\(G\(z\)\)=[0-9.]+ D\(E\(x\)\)=[0-9.]+ \([0-9.]+ steps/s", logs["gan"])) == 2

    scm = load_attribute_scm(str(models / "mnist-attribute-scm.tar"), "cpu")
    samp = scm.sample(torch.Generator().manual_seed(0), n=16, device="cpu")
    assert all(torch.isfinite(v.float()).all() for v in samp.values())
    assert "nll=" in logs["scm"]

    x = torch.from_numpy(load_mnist_training_data(str(data), "test")[0][:4])
    assert tuple(load_classifier(str(models / "mnist_clf.tar"), ccfg, "cpu")(x).shape) == (4, 10)
    assert "val_acc=" in logs["clf"]
    ae = load_classifier(str(models / "ae-all.tar"), tclf.AutoEncoderConfig(latent_dim=8), "cpu")
    assert isinstance(ae, tclf.ConvAutoEncoder) and tuple(ae(x).shape) == (4, 28, 28, 1)
    assert "mse=" in logs["ae"]

    assert read_png(str(models / "attribute-scm-hists.png")).shape == (3 * 48, 100)
    for epoch in (1, 2):
        assert read_png(str(models / f"epoch-{epoch}.png")).shape == (3 * 28, 10 * 28)


def test_resume_continues_bit_for_bit(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "run"
    run("train_mnist_image_scm", *gan_args(data, out, "--steps", 1))
    log = run("train_mnist_image_scm", *gan_args(data, out, "--steps", 2, "--resume"))
    assert f"at epoch 1 (step {N_TRAIN // BATCH})" in log
    got, _, _ = load_bigan(str(out / "mnist-bigan.tar"), "cpu")
    want, _, _ = load_bigan(str(models / "mnist-bigan.tar"), "cpu")

    def same(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif torch.is_tensor(b):
            assert torch.equal(a, b), path
        else:
            assert a == b, path
    same(got, want, "state")


def test_throughput_mode_takes_one_d_update_a_step(trained, tmp_path):
    data, _, _ = trained
    out = tmp_path / "fast"
    run("train_mnist_image_scm", *gan_args(data, out, "--steps", 1, "--throughput"))
    state, _, _ = load_bigan(str(out / "mnist-bigan.tar"), "cpu")
    assert state["step"] == state["opt_d"]["count"] == N_TRAIN // BATCH
    assert {m.dtype for m in state["opt_d"]["mu"].values()} == {torch.bfloat16}
    assert {v.dtype for v in state["opt_d"]["nu"].values()} == {torch.float32}


def test_serving_clis_run_on_the_artifacts(trained, tmp_path):
    data, models, _ = trained
    png = tmp_path / "cf.png"
    log = run("mnist_gan_counterfactuals", "--data-dir", data, "--model-dir", models,
              "--n-images", 4, "--output", png)
    assert "do(thickness+2)" in log
    grid = read_png(str(png))
    assert grid.shape == (3 * 28, 4 * 28)
    x = load_mnist_training_data(str(data), "test")[0][:4, :, :, 0]  # the test split's first rows
    np.testing.assert_array_equal(grid[:28], np.round((np.concatenate(x, axis=1) + 1) / 2 * 255))

    args = ("--data-dir", data, "--model-dir", models, "--limit", 48, "--batch-size", 16)
    score(run("mnist_bigan_score", *args, "--mc-rounds", 2), "cf digit accuracy")
    score(run("mnist_bigan_score", *args, "--held-out-shift", 1, 0, 0), "cf digit accuracy")
    score(run("mnist_generator_score", "--model-dir", models, "--n", 32),
          "generated-sample digit accuracy")
    score(run("mnist_generator_score", "--model-dir", models, "--data-dir", data, "--n", 32),
          "generated-sample digit accuracy")


# ------------------------------------------------- the JAX package's files


def test_jax_artifacts_load_into_the_port(trained, narrow, tmp_path):
    data, _, _ = trained
    cfg, ccfg = narrow
    jdir = tmp_path / "jax-models"
    jdir.mkdir()
    _, st, rng = jax_state("mnist", 0, {})
    x_np, attrs = jmnist.load_mnist_arrays(str(data), "train")
    jscaler = JScaler.fit(J_SPEC, attrs)
    jcommon.save_bigan(str(jdir / "mnist-bigan.tar"), st, jscaler)
    i, s = attrs["intensity"], attrs["slant"]
    graph = j_build(i.min(), i.max(), s.min(), s.max())
    jscm = JSCM(graph, *jax.device_get(graph.init(jax.random.PRNGKey(1))))
    jcommon.save_attribute_scm(str(jdir / "mnist-attribute-scm.tar"), jscm)
    jccfg = dataclasses.replace(jclf.mnist_classifier_config(),
                                plan=narrow_plan(jclf.mnist_classifier_config().plan, 8, keep_last=False))
    jm_clf = jclf.CNNClassifier(jccfg)
    cparams = redraw(jm_clf.init(jax.random.PRNGKey(2), jnp.zeros((2, 28, 28, 1)))["params"], rng)
    jckpt.save_checkpoint(str(jdir / "mnist_clf.tar"), {"params": cparams}, meta={"kind": "mnist-clf"})
    for name in ("mnist-bigan.tar", "mnist-attribute-scm.tar", "mnist_clf.tar"):
        assert checkpoint_format(str(jdir / name)) == "jax"

    x, _, _ = load_mnist_training_data(str(data), "train")
    xb, ab = x[:8], {k: v[:8] for k, v in attrs.items()}
    state, scaler, _ = load_bigan(str(jdir / "mnist-bigan.tar"), "cpu")
    engine = CounterfactualEngine(bigan_from_state(state, cfg, "cpu"),
                                  load_attribute_scm(str(jdir / "mnist-attribute-scm.tar"), "cpu"),
                                  scaler, "cpu")
    jeng = JEngine(jbigan.BiGAN(narrow_config(jbigan, "mnist")), st.params_E, st.params_G, jscm, jscaler)
    want = np.asarray(jeng.reconstruct(jnp.asarray(xb), {k: jnp.asarray(v) for k, v in ab.items()}))
    got = engine.reconstruct(xb, ab).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    logits = load_classifier(str(jdir / "mnist_clf.tar"), ccfg, "cpu")(torch.from_numpy(xb))
    jlogits = np.asarray(jm_clf.apply({"params": cparams}, jnp.asarray(xb)))
    assert np.abs(logits.detach().numpy() - jlogits).max() <= 1e-4 * max(1.0, np.abs(jlogits).max())

    # the port's CLIs score the JAX model directory, and resume its BiGAN
    run("mnist_gan_counterfactuals", "--data-dir", data, "--model-dir", jdir, "--n-images", 2,
        "--output", tmp_path / "cf.png")
    score(run("mnist_bigan_score", "--data-dir", data, "--model-dir", jdir, "--limit", 32,
              "--batch-size", 16), "cf digit accuracy")
    score(run("mnist_generator_score", "--model-dir", jdir, "--n", 16), "generated-sample digit accuracy")
    log = run("train_mnist_image_scm", *gan_args(data, jdir, "--steps", 1, "--resume"))
    assert "resumed from" in log and "(step 0)" in log
    resumed, _, _ = load_bigan(str(jdir / "mnist-bigan.tar"), "cpu")
    assert checkpoint_format(str(jdir / "mnist-bigan.tar")) == "torch"
    assert resumed["step"] == N_TRAIN // BATCH and resumed["rng"] is not None


# ------------------------------------------------------------ the PNG


def test_png_grid_decodes_back_to_its_rows(tmp_path, capsys):
    rng = np.random.default_rng(0)
    rows = [rng.uniform(-1, 1, (3, 5, 7)).astype(np.float32) for _ in range(2)]
    path = str(tmp_path / "g.png")
    pix = save_grid_png(path, rows, ["first", "second"], title="t")
    out = capsys.readouterr().out
    assert "t" in out and "row 1: first" in out and "row 2: second" in out
    got = read_png(path)
    want = np.round((np.concatenate([np.concatenate(list(r), axis=1) for r in rows]) + 1) / 2 * 255)
    assert got.shape == (10, 21) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pix)


def test_unknown_files_name_both_magics(tmp_path):
    path = tmp_path / "x.tar"
    path.write_bytes(b"PK\x03\x04 not a checkpoint")
    with pytest.raises(ValueError, match="ICFP.*ICFT"):
        checkpoint_format(str(path))
    with pytest.raises(ValueError, match="ICFP.*ICFT"):
        load_bigan(str(path), "cpu")
