"""The port's measured-counterfactual and VAE CLIs (``python -m
imagecfgen_torch.cli.<name>``) on the CPU, at a small size: a 16-row
training split and a 16-row test split synthesised at ``--scale 4`` by the
port's dataset CLIs, narrow BiGAN, VAE and classifier configs (every width
an eighth, latent 32) patched in where the CLIs build them, one VAE epoch at
batch 8.

- each parser takes every option string of its JAX script's parser, with the
  same defaults, plus ``--device``; ``--help`` runs with no card and with
  matplotlib, PIL, pandas and tqdm unimportable; without ``--device cpu`` and
  with no card every CLI raises before it runs;
- the pipeline runs end to end: ``train_mnist_vae`` writes a checkpoint that
  loads back, both measured-CF CLIs print three finite median errors and
  write a PNG that decodes to its size, ``mnist_vae_counterfactuals`` (with
  two spawned workers for the ground truth) prints both models' pixel MAE,
  both VAE scores lie in [0, 1], ``test_vae`` prints ``ok`` at full width;
- a ``mnist-vae.tar`` the JAX package wrote loads into the port, whose
  counterfactual matches the JAX script's ``vae_cf`` within
  1e-4·max(1, max|x|) (the ``test_torch_cf_engine.py`` images' tolerance),
  and the port's CLIs score it.
"""
import ast
import contextlib
import dataclasses
import importlib
import io
import json
import os
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
from test_torch_train_layers import narrow_config, narrow_plan, redraw

from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_torch.cli.common import (
    load_mnist_training_data,
    load_vae,
    read_png,
    scatter_panel,
)
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import vae as tvae

REPO = Path(__file__).resolve().parents[1]
CLIS = ("train_mnist_vae", "mnist_gan_measured_cf", "mnist_vae_measured_cf",
        "mnist_vae_counterfactuals", "mnist_vae_score", "mnist_vae_generator_score")
TENSOR_CLIS = CLIS + ("test_vae",)  # the JAX test_vae.py has no parser
NEW_CLIS = TENSOR_CLIS + ("create_train_dataset", "create_test_dataset")
N, BATCH = 16, 8
PANEL = 96  # scatter_panel's default size


def narrow_vae_config(mod):
    """Either package's narrow MNIST config with the VAE's init scale."""
    return dataclasses.replace(narrow_config(mod, "mnist"), init_std=1e-4)


@contextlib.contextmanager
def narrow_models():
    """The narrow BiGAN, VAE and classifier configs, patched in where the
    CLIs build theirs, for the length of the block."""
    cfg = narrow_config(tbigan, "mnist")
    vcfg = narrow_vae_config(tbigan)
    full = tclf.mnist_classifier_config()
    ccfg = dataclasses.replace(full, plan=narrow_plan(full.plan, 8, keep_last=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbigan, "mnist_bigan_config", lambda: cfg)
        mp.setattr(tvae, "mnist_vae_config", lambda: vcfg)
        mp.setattr(tclf, "mnist_classifier_config", lambda: ccfg)
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


def score(text: str, what: str) -> float:
    value = float(re.search(rf"{what}: ([0-9.]+)", text).group(1))
    assert 0.0 <= value <= 1.0
    return value


def median_errors(text: str) -> dict:
    found = re.search(r"median abs errors: (\{.*\})", text)
    errors = ast.literal_eval(found.group(1))  # a nan, too, fails here
    assert all(np.isfinite(v) for v in errors.values()), errors
    return errors


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("morpho-cli")
    data, models = root / "data", root / "models"
    small = ("--synthetic", N, "--scale", 4, "--workers", 1, "--out-dir", data)
    logs = {
        "train_set": run("create_train_dataset", *small, device=False),
        "test_set": run("create_test_dataset", *small, device=False),
        "scm": run("train_mnist_attribute_scm", "--data-dir", data, "--output-path", models,
                   "--steps", 3, "--batch-size", N),
        "clf": run("train_mnist_clf", "--data-dir", data, "--output-path", models, "--epochs", 1,
                   "--batch-size", BATCH),
        "gan": run("train_mnist_image_scm", "--data-dir", data, "--output-path", models,
                   "--batch-size", BATCH, "--steps", 1),
        "vae": run("train_mnist_vae", "--data-dir", data, "--output-path", models, "--steps", 1,
                   "--batch-size", BATCH),
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
        assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
            a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest
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
        f"for name in {list(NEW_CLIS)!r}:\n"
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


@pytest.mark.parametrize("name", NEW_CLIS)
def test_help_needs_no_card_and_no_missing_package(name, help_texts):
    text = help_texts[name]
    assert text.startswith("usage:")
    assert ("--device" in text) == (name in TENSOR_CLIS)


@pytest.mark.parametrize("name", TENSOR_CLIS)
def test_cli_without_a_card_raises_before_it_runs(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if name == "test_vae" else ["--data-dir", str(tmp_path / "none")]
    if name == "train_mnist_vae":
        argv += ["--output-path", str(tmp_path / "out")]
    elif name != "test_vae":
        argv += ["--model-dir", str(tmp_path / "none")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv)
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------ the pipeline


def test_dataset_clis_impose_the_attributes(trained):
    data, _, logs = trained
    for split in ("train", "test"):
        x = np.load(data / f"mnist-x-{split}.npy")
        a = np.load(data / f"mnist-a-{split}.npy")
        assert x.shape == (N, 28, 28) and a.shape == (N, 13)
        assert (x.max(axis=(1, 2)) > 50).all()
        np.testing.assert_array_equal(a[:, :10].sum(axis=1), 1.0)
    assert f"wrote {N} images" in logs["train_set"] and f"wrote {N} test images" in logs["test_set"]


def test_train_mnist_vae_writes_a_checkpoint_that_loads_back(trained):
    data, models, logs = trained
    assert re.search(r"epoch 1/1: -elbo=-?[0-9.]+ \([0-9.]+ steps/s\)", logs["vae"]), logs["vae"]
    path = str(models / "mnist-vae.tar")
    assert checkpoint_format(path) == "torch"
    vae, scaler, meta = load_vae(path, narrow_vae_config(tbigan), "cpu")
    assert meta == {"kind": "vae-mnist", "epoch": 1}
    assert not vae.training
    _, attrs, want = load_mnist_training_data(str(data), "train")
    for part in ("mins", "maxs"):
        assert scaler.state_dict()[part] == want.state_dict()[part]
    # the epoch's two Adam steps move the decoder; at the N(0, 1e-4) init the
    # narrow encoder's gradients are ~1e-20 after two steps, and their
    # updates round away at 1e-4 in float32
    fresh = tvae.ConditionalVAE(narrow_vae_config(tbigan), "cpu", torch.Generator().manual_seed(0))
    init = dict(fresh.named_parameters())
    for name, p in vae.decoder.named_parameters():
        assert not torch.equal(p, init[f"decoder.{name}"]), name


def test_measured_cf_clis_print_errors_and_write_panels(trained, tmp_path):
    data, models, _ = trained
    common = ("--data-dir", data, "--model-dir", models, "--limit", 8, "--workers", 2)
    errors = median_errors(run("mnist_gan_measured_cf", *common, "--output", tmp_path / "gan.png"))
    assert set(errors) == {"thickness", "intensity", "slant"}
    assert read_png(str(tmp_path / "gan.png")).shape == (PANEL, 3 * PANEL)

    errors = median_errors(run("mnist_vae_measured_cf", *common, "--output", tmp_path / "vae.png"))
    assert set(errors) == {"thickness", "intensity", "slant"}
    assert read_png(str(tmp_path / "vae.png")).shape == (PANEL, 3 * PANEL)
    log = run("mnist_vae_measured_cf", *common, "--cf-attribute", "slant", "--latent-dim", 7,
              "--output", tmp_path / "slant.png")
    assert set(median_errors(log)) == {"slant"}
    assert read_png(str(tmp_path / "slant.png")).shape == (PANEL, PANEL)


def test_vae_counterfactuals_with_spawned_workers(trained):
    """``--workers 2``: the ground truth is re-perturbed in a spawned pool
    through a module-level worker (the JAX script's closure cannot be
    pickled once the CLI is a function)."""
    data, models, _ = trained
    args = ("--data-dir", data, "--model-dir", models, "--limit", 4, "--scale", 4)
    one = run("mnist_vae_counterfactuals", *args, "--workers", 1)
    two = run("mnist_vae_counterfactuals", *args, "--workers", 2)
    assert one == two
    for model in ("bigan", "vae"):
        mae = float(re.search(rf"{model}: pixel MAE vs ground-truth do\(thickness\+2\) = ([0-9.]+)",
                              two).group(1))
        assert 0.0 <= mae <= 255.0


def test_vae_scores_lie_in_the_unit_interval(trained):
    data, models, _ = trained
    args = ("--data-dir", data, "--model-dir", models, "--limit", N, "--batch-size", BATCH)
    score(run("mnist_vae_score", *args), "vae cf digit accuracy")
    score(run("mnist_vae_score", *args, "--held-out-shift", 1, 0, 0), "vae cf digit accuracy")
    score(run("mnist_vae_generator_score", "--model-dir", models, "--n", 16),
          "vae generated-sample digit accuracy")


def test_test_vae_runs_at_full_width():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert importlib.import_module("imagecfgen_torch.cli.test_vae").main(["--device", "cpu"]) == 0
    text = out.getvalue()
    assert "encoder sample: (2, 1, 1, 512)" in text and "decoder: (2, 28, 28, 1)" in text
    assert text.rstrip().endswith("ok")


# ------------------------------------------------- the JAX package's VAE


def test_jax_vae_checkpoint_gives_the_jax_counterfactual(trained, tmp_path):
    data, models, _ = trained
    jdir = tmp_path / "jax-models"
    jdir.mkdir()
    rng = np.random.default_rng(0)
    jm = jvae.ConditionalVAE(narrow_vae_config(jbigan))
    x, attrs, _ = jcommon.load_mnist_training_data(str(data), "test")
    xb = jnp.asarray(x[:8])
    ab = {k: jnp.asarray(v[:8]) for k, v in attrs.items()}
    key = jax.random.PRNGKey(0)
    params = redraw({"encoder": jm.encoder.init({"params": key}, xb, ab)["params"],
                     "decoder": jm.decoder.init({"params": key}, jnp.zeros((8, 1, 1, 32)), ab)["params"]},
                    rng)
    jscaler = jcommon.load_mnist_training_data(str(data), "train")[2]
    jckpt.save_checkpoint(str(jdir / "mnist-vae.tar"), {"params": params, "scaler": jscaler.state_dict()},
                          meta={"kind": "vae-mnist", "epoch": 1})
    assert checkpoint_format(str(jdir / "mnist-vae.tar")) == "jax"

    # the JAX script's vae_cf: do(thickness + 2) on the observed attributes
    cf_ab = dict(ab, thickness=ab["thickness"] + 2.0)
    mean, _ = jm.encoder.apply({"params": params["encoder"]}, xb, jscaler.scale(ab))
    want = np.asarray(jm.decoder.apply({"params": params["decoder"]}, mean, jscaler.scale(cf_ab)))

    vae, scaler, meta = load_vae(str(jdir / "mnist-vae.tar"), narrow_vae_config(tbigan), "cpu")
    assert meta["kind"] == "vae-mnist"
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in ab.items()}
    got = vae.counterfactual(torch.from_numpy(np.asarray(xb)), scaler.scale(t),
                             scaler.scale(dict(t, thickness=t["thickness"] + 2.0))).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())

    # the port's CLIs serve it, with the port-trained SCM and classifier
    scm, clf = str(models / "mnist-attribute-scm.tar"), str(models / "mnist_clf.tar")
    log = run("mnist_vae_measured_cf", "--data-dir", data, "--model-dir", jdir, "--attr-model-file", scm,
              "--limit", 4, "--workers", 1, "--output", tmp_path / "m.png")
    median_errors(log)
    score(run("mnist_vae_score", "--data-dir", data, "--model-dir", jdir, "-a", scm, "-c", clf,
              "--limit", 8, "--batch-size", 8), "vae cf digit accuracy")
    score(run("mnist_vae_generator_score", "-m", jdir / "mnist-vae.tar", "-a", scm, "-c", clf, "--n", 8),
          "vae generated-sample digit accuracy")


# ------------------------------------------------------------ the panel


def test_scatter_panel_puts_points_and_the_diagonal_in_place():
    img = scatter_panel([0.0, 1.0, 0.5], [0.0, 1.0, 0.0], size=21)
    assert img.shape == (21, 21) and img.dtype == np.float32
    assert img[20, 0] == img[0, 20] == 1.0  # (0, 0) bottom left, (1, 1) top right
    assert img[20, 10] == 1.0  # (0.5, 0): bottom row, middle column
    assert img[10, 10] == 0.5 and img[5, 15] == 0.5  # the line y = x off the marks
    assert img[2, 10] == 0.0
    flat = scatter_panel([np.nan, 2.0], [np.inf, 2.0], size=9)  # one finite point, no range
    assert np.isfinite(flat).all() and flat.max() == 1.0
