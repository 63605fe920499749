"""The port's ten AudioMNIST CLIs (``python -m imagecfgen_torch.cli.<name>``) on
the CPU, at a small size: the BiGAN at d = 2, the classifiers at
``--width 0.0625``, on the synthetic stand-in at two runs a (subject, digit)
cut to its first 4 subjects (40 training and 40 validation clips), in
both packages alike.

- each parser takes every option string of its JAX script's parser, with the
  same defaults, plus ``--device``;
- ``--help`` runs with no card and with matplotlib, PIL and torchaudio
  unimportable; without ``--device cpu`` and with no card every CLI raises
  before it runs;
- the pipeline runs end to end: the attribute SCM, the digit and subject
  classifiers, the BiGAN in float32 and in bfloat16 (whose ``--resume``
  continues bit for bit), the score CLIs, generation (int16 wavs), the
  reconstruction grid and wavs, and both identity-preservation CLIs;
- a model directory that the JAX package wrote (BiGAN, SCM, classifiers,
  VAE) runs through the port's CLIs and gives the JAX scripts' deterministic
  outputs: the reconstruction grid's real and reconstructed spectrograms to
  2e-3 of their range (the port's STFT and the JAX package's differ by up to
  5e-4 in image units where the power is near zero; E and G carry that on),
  and the ``bigan`` and ``vae`` ratio matrices to 1e-4 relative (ratios of
  mean squared distances over 16,384 pixels).
"""
import contextlib
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
from scipy.io import wavfile
from test_torch_train_layers import redraw

from imagecfgen_tpu.cli import audio_common as jaudio
from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.data import audio_mnist as jdata
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.scm.audio_mnist import AudioMNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.audio_mnist import build_audio_mnist_graph as j_build
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.cli import audio_common as taudio
from imagecfgen_torch.cli import common as tcommon
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.data import audio_mnist as tdata
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.scm.audio_mnist import CARDINALITIES

REPO = Path(__file__).resolve().parents[1]
CLIS = ("train_audio_mnist_attribute_scm", "train_audio_mnist_clf", "train_audio_mnist_bigan",
        "audiomnist_bigan_score", "audiomnist_generator_score", "test_audio_gan", "audiomnist_generate",
        "audio_mnist_reconstruction", "audiomnist_cf_eval", "audiomnist_cf_classifier_metric")
SUBJECTS, BATCH, D, WIDTH = 4, 16, 2, 0.0625
N_TRAIN = 10 * SUBJECTS  # run 0 of each (subject, digit); run 1 is the validation run


def first_subjects(data, n: int = SUBJECTS):
    """The dataset cut to subjects 1..n (either package's class)."""
    keep = data.raw["subject"] <= n
    data.raw = {k: v[keep] for k, v in data.raw.items()}
    data._fit_encoders()
    return data


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its 128x128 convs on
    several threads, beside the suite's other workers, oversubscribe the
    host's cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_data():
    """Both packages' ``load_audio_dataset`` return the cut stand-in."""
    jd, td = first_subjects(jdata.AudioMNISTData(None, 2)), first_subjects(tdata.AudioMNISTData(None, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(taudio, "load_audio_dataset", lambda zip_path, synthetic_runs=4: td)
        mp.setattr(jaudio, "load_audio_dataset", lambda zip_path, synthetic_runs=4: jd)
        yield jd, td


def run(name: str, *argv) -> str:
    """One port CLI through its ``main`` on the CPU; what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = importlib.import_module(f"imagecfgen_torch.cli.{name}").main([*map(str, argv), "--device", "cpu"])
    assert code == 0
    return out.getvalue()


def run_jax(name: str, *argv) -> str:
    """One JAX script as ``__main__`` in this process (JAX is on the CPU
    here), its hard exit and excepthook stood in for; what it printed."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jcommon, "clean_exit", lambda code=0: None)
        mp.setattr(jcommon, "install_cli_excepthook", lambda: None)
        mp.setattr(sys, "argv", [name, *map(str, argv)])
        runpy.run_path(str(REPO / f"{name}.py"), run_name="__main__")
    return out.getvalue()


def printed(text: str, what: str) -> float:
    value = float(re.search(rf"{what}(?::| =) ([0-9.]+)", text).group(1))
    assert 0.0 <= value <= 1.0
    return value


# ------------------------------------------------------------ the parsers


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x").get("parser")
    if jparser is None:  # test_audio_gan: the JAX script takes no flags
        assert name == "test_audio_gan" and _options(tparser) == {"-h", "--help", "--device"}
    else:
        assert _options(tparser) == _options(jparser) | {"--device"}
        port = {a.dest: a for a in tparser._actions}
        for a in jparser._actions:
            t = port[a.dest]
            assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
                a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest
    assert tparser.parse_args([]).device == "cuda"
    assert tparser.parse_args(["--device", "cpu"]).device == "cpu"


@pytest.fixture(scope="module")
def helps():
    """Every CLI's ``--help`` in one fresh interpreter with no card and with
    matplotlib, PIL and torchaudio unimportable: ``{name: text}``."""
    code = (
        "import contextlib, importlib.abc, io, json, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'PIL', 'torchaudio'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "out = {}\n"
        f"for name in {CLIS!r}:\n"
        "    sys.argv, buf = [name, '--help'], io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            runpy.run_module('imagecfgen_torch.cli.' + name, run_name='__main__')\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (name, e.code)\n"
        "    out[name] = buf.getvalue()\n"
        "print(json.dumps(out))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=180, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CLIS)
def test_help_needs_no_card_and_no_matplotlib(helps, name):
    assert helps[name].startswith("usage:") and "--device" in helps[name]


@pytest.mark.parametrize("name", CLIS)
def test_cli_without_a_card_raises_before_it_runs(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_audio_mnist_attribute_scm": ["--output-path", str(tmp_path / "out")],
            "train_audio_mnist_clf": ["--output-path", str(tmp_path / "out")],
            "train_audio_mnist_bigan": ["--output-path", str(tmp_path / "out")],
            "test_audio_gan": [], "audiomnist_generate": ["--outdir", str(tmp_path / "out")],
            "audio_mnist_reconstruction": ["--output", str(tmp_path / "out")],
            "audiomnist_cf_eval": ["--out-dir", str(tmp_path / "out")]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv + ["--model-dir", str(tmp_path)]
                                                                      if "model_dir" in _dests(name) else argv)
    assert not (tmp_path / "out").exists()


def _dests(name):
    return {a.dest for a in importlib.import_module(f"imagecfgen_torch.cli.{name}").parser._actions}


# ------------------------------------------------------------ the pipeline


def gan_args(out, *extra):
    return ("--output-path", out, "--d", D, "--batch-size", BATCH, "--init-std", 0.01,
            "--checkpoint-every", 1, *extra)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, small_data):
    models = tmp_path_factory.mktemp("audio-cli") / "models"
    logs = {
        "scm": run("train_audio_mnist_attribute_scm", "--output-path", models, "--steps", 5,
                   "--batch-size", N_TRAIN),
        "digit": run("train_audio_mnist_clf", "--output-path", models, "--epochs", 5, "--width", WIDTH,
                     "--batch-size", BATCH),
        "subject": run("train_audio_mnist_clf", "--output-path", models, "--epochs", 1, "--width", WIDTH,
                       "--batch-size", BATCH, "--attribute", "subject"),
        "gan": run("train_audio_mnist_bigan", *gan_args(models, "--steps", 2)),
    }
    return models, logs


def test_training_clis_write_artifacts_that_load_back(trained):
    models, logs = trained
    steps = 2 * (N_TRAIN // BATCH)
    state, stats, meta = taudio.load_audio_bigan(str(models / "audio-mnist-bigan.tar"), "cpu")
    assert checkpoint_format(str(models / "audio-mnist-bigan.tar")) == "torch"
    assert meta["kind"] == "bigan-audio-mnist" and meta["epoch"] == 2 and meta["d"] == D
    assert meta["vocabs"]["digit"] == [str(d) for d in range(10)] and len(meta["vocabs"]["age_edges"]) == 6
    assert state["step"] == steps and state["opt_d"]["count"] == 2 * steps == 2 * state["opt_eg"]["count"]
    assert tuple(stats.mean.shape) == tuple(stats.std.shape) == (1, 1, 128)
    assert f"training on {N_TRAIN} spectrograms" in logs["gan"]
    assert len(re.findall(r"D\(G\(z\)\)=[0-9.]+ D\(E\(x\)\)=[0-9.]+ \([0-9.]+ steps/s", logs["gan"])) == 2
    model, _, _ = taudio.load_audio_bigan_model(str(models / "audio-mnist-bigan.tar"), "cpu")
    assert model.cfg.enc_plan[0][1] == D

    scm = taudio.load_audio_scm(str(models / "audio-mnist-attribute-scm.tar"), "cpu")
    samp = scm.sample(torch.Generator().manual_seed(0), n=16, device="cpu")
    assert set(samp) == {"accent", "age", "country_of_origin", "digit", "gender", "native_speaker"}
    assert "nll=" in logs["scm"]
    x = torch.zeros(2, 128, 128, 1)
    for attr, n in (("digit", 10), ("subject", 60)):
        clf, cstats, cmeta = taudio.load_audio_classifier(str(models / f"audio-mnist-{attr}-clf.tar"), n, "cpu")
        assert cmeta == {"kind": "audio-mnist-clf", "attribute": attr, "n_classes": n, "width": WIDTH}
        assert tuple(clf(x).shape) == (2, n) and torch.equal(cstats.mean, stats.mean)
    assert "val_acc=" in logs["digit"]


def test_bf16_training_keeps_float32_state_and_resumes_bit_for_bit(small_data, tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    bf16 = ("--compute-dtype", "bfloat16")
    run("train_audio_mnist_bigan", *gan_args(straight, "--steps", 2, *bf16))
    run("train_audio_mnist_bigan", *gan_args(split, "--steps", 1, *bf16))
    log = run("train_audio_mnist_bigan", *gan_args(split, "--steps", 2, "--resume", *bf16))
    assert f"at epoch 1 (step {N_TRAIN // BATCH})" in log
    got, _, meta = taudio.load_audio_bigan(str(split / "audio-mnist-bigan.tar"), "cpu")
    want, _, _ = taudio.load_audio_bigan(str(straight / "audio-mnist-bigan.tar"), "cpu")
    assert meta["compute_dtype"] == "bfloat16"

    def same(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif torch.is_tensor(b):
            assert torch.equal(a, b), path
            if b.is_floating_point():
                assert b.dtype == torch.float32, path
        else:
            assert a == b, path
    same(got, want, "state")


def test_score_clis_run_on_the_artifacts(trained, monkeypatch):
    models, _ = trained
    printed(run("audiomnist_bigan_score", "--model-dir", models, "--batch-size", 64, "--mc-rounds", 2),
            "digit cf accuracy")
    printed(run("audiomnist_generator_score", "--model-dir", models, "--n", 40, "--batch-size", 16,
                "--mc-rounds", 1), "generated digit accuracy")
    small = tbigan.audio_mnist_bigan_config
    monkeypatch.setattr(tbigan, "audio_mnist_bigan_config", lambda **kw: small(d=D, **kw))
    log = run("test_audio_gan")
    assert "E(x, c): (2, 1, 1, 512)" in log and "D(x, z, c): (2, 1)" in log and log.strip().endswith("ok")


def test_generate_writes_int16_wavs_and_attributes(trained, tmp_path):
    models, _ = trained
    log = run("audiomnist_generate", "--model-dir", models, "--outdir", tmp_path, "-n", 3, "--mc-rounds", 2,
              "--digit-clf", models / "audio-mnist-digit-clf.tar")
    assert "wrote 3 wav/json pairs" in log
    for i in range(3):
        sr, wav = wavfile.read(tmp_path / f"sample-{i}.wav")
        # 128 frames back through the unpadded inverse, as the JAX script: 255 + 64 * 127 - 2 * 127
        assert sr == 8000 and wav.dtype == np.int16 and wav.shape == (8129,)
        assert np.abs(wav).max() == 32767  # peak-normalised: not silent
        record = json.loads((tmp_path / f"sample-{i}.json").read_text())
        assert set(record) == {"accent", "age", "country_of_origin", "digit", "gender", "native_speaker",
                               "digit_pred"}
        assert record["age"].startswith("bin-") and record["digit"] in [str(d) for d in range(10)]


def test_reconstruction_grid_and_wavs(trained, tmp_path):
    models, _ = trained
    run("audio_mnist_reconstruction", "--model-dir", models, "--output", tmp_path, "--n-show", 3, "--write-wavs")
    assert tcommon.read_png(str(tmp_path / "reconstructions.png")).shape == (3 * 128, 3 * 128)
    for name in ("generated", "real", "reconstructed"):
        sr, wav = wavfile.read(tmp_path / f"{name}.wav")
        assert sr == 8000 and wav.dtype == np.int16 and np.abs(wav).max() == 32767


def test_identity_preservation_clis(trained, tmp_path):
    models, _ = trained
    log = run("audiomnist_cf_eval", "--model-dir", models, "--out-dir", tmp_path,
              "--bigan-ft", "audio-mnist-bigan.tar")
    for m in ("bigan", "bigan_ft", "bigan_int"):
        assert re.search(rf"{m}: mean ratio [0-9.]+", log)
    mats = {m: np.load(tmp_path / f"{m}_{'cf_' if m != 'bigan_int' else ''}metric_mat.npy", allow_pickle=True)
            for m in ("bigan", "bigan_ft", "bigan_int")}
    assert mats["bigan"].shape == (SUBJECTS, 10, 9)  # one validation clip a (subject, digit): 9 others
    assert np.isfinite(mats["bigan"].astype(float)).all()
    np.testing.assert_array_equal(mats["bigan"].astype(float), mats["bigan_ft"].astype(float))
    log = run("audiomnist_cf_classifier_metric", "--model-dir", models)
    for m in ("bigan", "bigan_int"):
        printed(log, f"{m}: subject-identity accuracy after digit CF")


# ------------------------------------------------- the JAX package's files


def drawn(module, rng, *args, **kw):
    """Parameters for a JAX module, their shapes from an abstract ``init``,
    their values drawn with numpy at O(1) (``redraw``)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init({"params": key, "dropout": key}, *args, **kw))["params"]
    return redraw(shapes, rng)


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory, small_data):
    """A model directory that the JAX package's functions wrote, at d = 2
    and width 0.0625, with O(1) weights."""
    jd, _ = small_data
    out = tmp_path_factory.mktemp("jax-audio") / "models"
    out.mkdir()
    rng = np.random.default_rng(0)
    _, _, stats = jaudio.prepare_training_arrays(jd)
    model = jbigan.BiGAN(jbigan.audio_mnist_bigan_config(d=D))
    x, z = jnp.zeros((2, 128, 128, 1)), jnp.zeros((2, 1, 1, 512))
    a = {k: jnp.zeros((2, n)).at[:, 0].set(1.0) for k, n in CARDINALITIES.items()}
    pE, pG = drawn(model.encoder, rng, x, a), drawn(model.generator, rng, z, a)
    pD = drawn(model.discriminator, rng, x, z, a, train=False)
    tx = jgt.GANTrainer(model, jgt.GANTrainConfig()).tx_eg
    st = jgt.GANState(params_E=pE, params_G=pG, vars_D={"params": pD, "batch_stats": {}},
                      opt_eg=tx.init({"E": pE, "G": pG}), opt_d=tx.init(pD), step=jnp.zeros((), jnp.int32),
                      rng=jax.random.PRNGKey(0))
    jaudio.save_audio_bigan(str(out / "audio-mnist-bigan.tar"), st, stats, jd, meta={"epoch": 1, "d": D})
    graph = j_build()
    jaudio.save_audio_scm(str(out / "audio-mnist-attribute-scm.tar"),
                          JSCM(graph, *jax.device_get(graph.init(jax.random.PRNGKey(1)))))
    for attr, n in (("digit", 10), ("subject", 60)):
        params = drawn(jclf.CNNClassifier(jclf.audio_mnist_classifier_config(n, width=WIDTH)), rng, x)
        jckpt.save_checkpoint(str(out / f"audio-mnist-{attr}-clf.tar"),
                              {"params": params, "spect_mean": np.asarray(stats.mean),
                               "spect_std": np.asarray(stats.std)},
                              meta={"kind": "audio-mnist-clf", "attribute": attr, "n_classes": n, "width": WIDTH})
    vae = jvae.ConditionalVAE(jvae.audio_mnist_vae_config(d=D))
    vparams = {"encoder": drawn(vae.encoder, rng, x, a), "decoder": drawn(vae.decoder, rng, z, a)}
    jckpt.save_checkpoint(str(out / "audio-mnist-vae.tar"), {"params": vparams},
                          meta={"kind": "vae-audio-mnist", "d": D})
    for f in out.iterdir():
        assert checkpoint_format(str(f)) == "jax"
    return out


def test_jax_model_dir_gives_the_jax_clis_reconstruction(jax_models, tmp_path, monkeypatch):
    grids = {}

    def capture(pkg, real):
        def save(path, rows, labels, title="", vmin=-1, vmax=1):
            grids[pkg] = [np.asarray(r) for r in rows]
            return real(path, rows, labels, title, vmin, vmax) if pkg == "port" else None
        return save

    monkeypatch.setattr(jcommon, "save_grid_png", capture("jax", jcommon.save_grid_png))
    monkeypatch.setattr(tcommon, "save_grid_png", capture("port", tcommon.save_grid_png))
    run_jax("audio_mnist_reconstruction", "--model-dir", jax_models, "--output", tmp_path / "jax", "--n-show", 3)
    run("audio_mnist_reconstruction", "--model-dir", jax_models, "--output", tmp_path / "port", "--n-show", 3)
    for row in (1, 2):  # x and G(E(x, c), c); row 0 draws its z
        want, got = grids["jax"][row], grids["port"][row]
        assert got.shape == want.shape == (3, 128, 128)
        span = want.max() - want.min()
        assert np.abs(got - want).max() <= 2e-3 * span, f"row {row}: {np.abs(got - want).max() / span:.2e}"
    assert tcommon.read_png(str(tmp_path / "port" / "reconstructions.png")).shape == (3 * 128, 3 * 128)


def test_jax_model_dir_gives_the_jax_clis_ratio_matrices(jax_models, tmp_path):
    argv = ("--model-dir", jax_models, "--vae", "audio-mnist-vae.tar")
    run_jax("audiomnist_cf_eval", *argv, "--out-dir", tmp_path / "jax")
    log = run("audiomnist_cf_eval", *argv, "--out-dir", tmp_path / "port")
    assert re.search(r"vae_int: mean ratio [0-9.]+", log)
    for name in ("bigan_cf_metric_mat.npy", "vae_cf_metric_mat.npy"):
        want = np.load(tmp_path / "jax" / name, allow_pickle=True)
        got = np.load(tmp_path / "port" / name, allow_pickle=True)
        assert got.shape == want.shape == (SUBJECTS, 10, 9) and got.dtype == want.dtype == object
        np.testing.assert_allclose(got.astype(float), want.astype(float), rtol=1e-4, err_msg=name)
    for name in ("bigan_int_metric_mat.npy", "vae_int_metric_mat.npy"):
        assert np.load(tmp_path / "port" / name, allow_pickle=True).shape == (SUBJECTS, 10, 9)


def test_port_clis_score_a_jax_model_dir(jax_models, tmp_path):
    printed(run("audiomnist_bigan_score", "--model-dir", jax_models, "--batch-size", 64, "--mc-rounds", 1),
            "digit cf accuracy")
    printed(run("audiomnist_generator_score", "--model-dir", jax_models, "--n", 16, "--mc-rounds", 1),
            "generated digit accuracy")
    log = run("audiomnist_cf_classifier_metric", "--model-dir", jax_models, "--vae", "audio-mnist-vae.tar")
    for m in ("bigan", "vae", "bigan_int"):
        printed(log, f"{m}: subject-identity accuracy after digit CF")
    run("audiomnist_generate", "--model-dir", jax_models, "--outdir", tmp_path, "-n", 2,
        "--digit-clf", jax_models / "audio-mnist-digit-clf.tar")
    assert wavfile.read(tmp_path / "sample-1.wav")[1].dtype == np.int16
    log = run("train_audio_mnist_bigan", "--output-path", jax_models, "--d", D, "--batch-size", BATCH,
              "--steps", 2, "--resume")
    assert "resumed from" in log and "at epoch 1 (step 0)" in log
    state, _, _ = taudio.load_audio_bigan(str(jax_models / "audio-mnist-bigan.tar"), "cpu")
    assert state["step"] == N_TRAIN // BATCH and state["rng"] is not None
