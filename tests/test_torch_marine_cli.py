"""The port's nine marine CLIs (``python -m imagecfgen_torch.cli.<name>``) on
the CPU, at a small size: the BiGANs and the whale VAE at d = 2, the NARW
classifier at ``--width 0.0078`` (8 channels), the whale stand-in at 4 clips
a class (9 training and 3 validation windows), the ESRF stand-in at 8
recordings (15 training windows) or 6 (11 validation windows), in both
packages alike.

- each parser takes every option string of its JAX script's parser
  (``tools/esrf_quality.py`` for ``esrf_quality``), with the same defaults,
  plus ``--device``; without ``--device cpu`` and with no card each CLI
  raises before it runs;
- the whale pipeline runs end to end (classifier, BiGAN with remat, VAE,
  fine-tune, both scores), and the ESRF one (BiGAN, fine-tune without the
  optimiser states, the quality tool); the BiGANs' and the VAE's
  ``--resume`` continue bit for bit, the state equal to an uninterrupted
  run's;
- a model directory that the JAX package's functions wrote (whale BiGAN,
  NARW classifier, whale VAE; ESRF BiGAN) is read by its magic:
  ``whale_cf_score`` with the class draws of the JAX script's key chain
  injected prints the JAX script's tallies, ``esrf_quality`` the JAX tool's
  numbers (reconstruction MSE to 1e-4 relative, SSIM and the band ratios to
  2e-3 of their values: the port's and the JAX package's spectrograms
  differ by up to 5e-4 in image units where the power is near zero, and E
  and G carry that on), and ``train_whale_bigan --resume`` continues the
  JAX file's step.
"""
import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layers import redraw

from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.cli import whale_common as jwc
from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.data.esrf import EsrfStation as JStation
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.ops.spectral import SpectStats as JStats
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.cli import whale_cf_score
from imagecfgen_torch.cli import whale_common as twc
from imagecfgen_torch.core.checkpoint import checkpoint_format, load_train_state

REPO = Path(__file__).resolve().parents[1]
CLIS = {"train_whale_clf": "train_whale_clf.py", "train_whale_bigan": "train_whale_bigan.py",
        "train_whale_vae": "train_whale_vae.py", "whale_generator_score": "whale_generator_score.py",
        "whale_cf_score": "whale_cf_score.py", "finetune_whale_bigan": "finetune_whale_bigan.py",
        "train_esrf_bigan": "train_esrf_bigan.py", "finetune_esrf_bigan": "finetune_esrf_bigan.py",
        "esrf_quality": "tools/esrf_quality.py"}
D, WIDTH, BATCH = 2, 0.0078, 4
WHALE = ("--synthetic-clips", 4)
ESRF_BATCH = 8
ESRF = ("--synthetic-recordings", 8, "--max-batches", 1)  # one boat recording among 6 training ones


def run(name: str, *argv) -> str:
    """One port CLI through its ``main`` on the CPU; what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = importlib.import_module(f"imagecfgen_torch.cli.{name}").main([*map(str, argv), "--device", "cpu"])
    assert code == 0
    return out.getvalue()


def run_jax(script: str, *argv) -> str:
    """One JAX script as ``__main__`` in this process (JAX is on the CPU
    here), its hard exit and excepthook stood in for; what it printed."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jcommon, "clean_exit", lambda code=0: None)
        mp.setattr(jcommon, "install_cli_excepthook", lambda: None)
        mp.setattr(sys, "argv", [script, *map(str, argv)])
        runpy.run_path(str(REPO / script), run_name="__main__")
    return out.getvalue()


def numbers(text: str, pattern: str):
    """Every group of every match of ``pattern``, as floats, in order."""
    return [float(v) for m in re.finditer(pattern, text) for v in m.groups()]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs, beside the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the parsers


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    jparser = runpy.run_path(str(REPO / CLIS[name]), run_name="x")["parser"]
    assert _options(tparser) == _options(jparser) | {"--device"}
    port = {tuple(a.option_strings): a for a in tparser._actions}
    for a in jparser._actions:
        t = port[tuple(a.option_strings)]
        assert (t.dest, t.default, t.nargs, t.type, t.const, t.choices) == (
            a.dest, a.default, a.nargs, a.type, a.const, a.choices), a.option_strings
    assert tparser.parse_args([]).device == "cuda"


@pytest.mark.parametrize("name", CLIS)
def test_cli_needs_a_card_unless_asked_for_the_cpu(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(["--output-path", str(tmp_path)]
                                                                     if "train" in name else [])


def test_a_missing_data_path_warns_and_takes_the_stand_in(tmp_path, capsys):
    data = twc.load_whale_dataset(str(tmp_path / "none"), None, None, synthetic_clips=1)
    assert data._synthetic is not None and "not found" in capsys.readouterr().out
    station = twc.load_esrf_dataset(str(tmp_path / "none"), None, synthetic_recordings=2)
    assert station._synthetic is not None and "not found" in capsys.readouterr().out


# ------------------------------------------------------------ the whale pipeline


@pytest.fixture(scope="module")
def whale_runs(tmp_path_factory):
    """The whale CLIs on the stand-in: a classifier, a BiGAN trained one
    epoch then resumed for a second beside an uninterrupted two-epoch run,
    the VAE likewise, a fine-tune and both scores."""
    root = tmp_path_factory.mktemp("whale")
    m, straight, vstraight = root / "m", root / "straight", root / "vstraight"
    gan = ("--d", D, "--batch-size", BATCH, "--remat", *WHALE)
    vae = ("--d", D, "--batch-size", BATCH, *WHALE)
    texts = {
        "clf": run("train_whale_clf", "--output-path", m, "--epochs", 5, "--width", WIDTH, "--batch-size", BATCH,
                   *WHALE),
        "bigan": run("train_whale_bigan", "--output-path", m, "--steps", 1, *gan),
        "resume": run("train_whale_bigan", "--output-path", m, "--steps", 2, "--resume", *gan),
        "straight": run("train_whale_bigan", "--output-path", straight, "--steps", 2, *gan),
        "vae": run("train_whale_vae", "--output-path", m, "--steps", 1, *vae),
        "vae_resume": run("train_whale_vae", "--output-path", m, "--steps", 2, "--resume", *vae),
        "vae_straight": run("train_whale_vae", "--output-path", vstraight, "--steps", 2, *vae),
    }
    with contextlib.chdir(m):
        texts["finetune"] = run("finetune_whale_bigan", "--model-file", "whale-bigan.tar", "--steps", 1,
                                "--batch-size", BATCH, *WHALE)
    texts["gen"] = run("whale_generator_score", "--model-dir", m, "--n", 8, "--batch-size", BATCH)
    texts["cf"] = run("whale_cf_score", "--model-dir", m, "--bigan-ft", "whale-bigan-finetuned-mse.tar",
                      "--vae", "whale-vae.tar", "--batch-size", 2, *WHALE)
    return root, texts


def same_state(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            same_state(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(b):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_whale_bigan_resumes_bit_for_bit(whale_runs):
    root, texts = whale_runs
    steps = 9 // BATCH
    assert f"at epoch 1 (step {steps})" in texts["resume"]
    got, _ = load_train_state(str(root / "m" / "whale-bigan.tar"), "cpu")
    want, meta = load_train_state(str(root / "straight" / "whale-bigan.tar"), "cpu")
    assert got["trainer"]["step"] == 2 * steps and meta == {"kind": "bigan-whale", "carries_rng": True,
                                                             "epoch": 2, "d": D}
    same_state(got, want)


def test_whale_vae_resumes_bit_for_bit(whale_runs):
    root, texts = whale_runs
    assert "at epoch 1 (step 2)" in texts["vae_resume"]
    got, meta = load_train_state(str(root / "m" / "whale-vae.tar"), "cpu")
    want, _ = load_train_state(str(root / "vstraight" / "whale-vae.tar"), "cpu")
    assert meta["kind"] == "vae-whale" and meta["epoch"] == 2
    same_state(got, want)


def test_whale_finetune_moves_e_alone(whale_runs):
    root, texts = whale_runs
    before, stats, _ = twc.load_whale_bigan(str(root / "m" / "whale-bigan.tar"), "cpu")
    after, after_stats, meta = twc.load_whale_bigan(str(root / "m" / "whale-bigan-finetuned-mse.tar"), "cpu")
    assert meta == {"kind": "bigan-whale", "carries_rng": False, "finetuned": "mse", "d": D}
    # at d = 2 and the config's N(0, 0.001) init the first layers' updates
    # round away; the last conv's kernel moves
    last = max(k for k in before["E"] if k.startswith("trunk.conv_") and k.endswith("kernel"))
    assert not torch.equal(before["E"][last], after["E"][last])
    for part in ("G", "D", "opt_eg", "opt_d"):
        same_state(after[part], before[part], part)
    assert torch.equal(stats.mean, after_stats.mean) and after["rng"] is None


def test_whale_scores_and_classifier(whale_runs):
    root, texts = whale_runs
    assert len(numbers(texts["clf"], r"val_acc=([0-9.]+)")) == 1
    clf, meta = twc.load_whale_classifier(str(root / "m" / "whale-clf.tar"), "cpu")
    assert meta["width"] == WIDTH and clf.trunk.dense_0_kernel.shape == (8, 32)
    acc = numbers(texts["gen"], r"generated call-type accuracy: ([0-9.]+)")
    assert len(acc) == 1 and 0.0 <= acc[0] <= 1.0
    tallies = dict(re.findall(r"(\w+): call-type cf accuracy = ([0-9.]+)", texts["cf"]))
    assert set(tallies) == {"bigan", "bigan_ft", "vae"}
    for v in tallies.values():  # of 3 validation windows
        assert min(abs(float(v) - k / 3) for k in range(4)) < 1e-4, v


def test_new_classes_are_the_other_two_uniformly():
    rng = torch.Generator().manual_seed(0)
    cur = torch.arange(3).repeat(2000)
    new = whale_cf_score.draw_new_classes(rng, cur)
    assert not (new == cur).any()
    for c in range(3):
        share = (new[cur == c] == (c + 1) % 3).float().mean().item()
        assert abs(share - 0.5) < 0.05


# ------------------------------------------------------------ the ESRF pipeline


@pytest.fixture(scope="module")
def esrf_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("esrf")
    gan = ("--d", D, "--batch-size", ESRF_BATCH, *ESRF)
    texts = {
        "bigan": run("train_esrf_bigan", "--output-path", root / "m", "--steps", 1, *gan),
        "resume": run("train_esrf_bigan", "--output-path", root / "m", "--steps", 2, "--resume", *gan),
        "straight": run("train_esrf_bigan", "--output-path", root / "straight", "--steps", 2, *gan),
        "finetune": run("finetune_esrf_bigan", "--model-file", root / "m" / "esrf-bigan.tar", "--output-path",
                        root / "m", "--steps", 1, "--batch-size", ESRF_BATCH, *ESRF),
    }
    texts["quality"] = run("esrf_quality", "--model-dir", root / "m", "--bigan", "esrf-bigan-finetuned-ssim.tar",
                           "--synthetic-recordings", 8, "--batch-size", BATCH)
    return root, texts


def test_esrf_bigan_resumes_bit_for_bit(esrf_runs):
    root, texts = esrf_runs
    n = int(re.search(r"training on (\d+) 512x512 windows", texts["bigan"]).group(1))
    assert n == 15 and f"at epoch 1 (step {n // ESRF_BATCH})" in texts["resume"]
    got, meta = load_train_state(str(root / "m" / "esrf-bigan.tar"), "cpu")
    want, _ = load_train_state(str(root / "straight" / "esrf-bigan.tar"), "cpu")
    assert meta == {"kind": "bigan-esrf", "carries_rng": True, "epoch": 2, "d": D}
    same_state(got, want)


def test_esrf_finetune_keeps_e_and_g_only(esrf_runs):
    root, texts = esrf_runs
    path = str(root / "m" / "esrf-bigan-finetuned-ssim.tar")
    payload, meta = load_train_state(path, "cpu")
    assert set(payload["trainer"]) == {"E", "G"} and meta["finetuned"] == "ssim" and meta["d"] == D
    before, stats, _ = twc.load_whale_bigan(str(root / "m" / "esrf-bigan.tar"), "cpu")
    same_state(payload["trainer"]["G"], before["G"])
    assert torch.equal(payload["spect_mean"], stats.mean)
    assert "ssim=" in texts["finetune"]


def test_esrf_quality_prints_its_metrics(esrf_runs):
    _, texts = esrf_runs
    text = texts["quality"]
    assert re.search(r"validation windows: \d+ \(no-boat \d+, boat \d+\)", text)
    mse, ss = numbers(text, r"reconstruction: mse=([0-9.]+) ssim=(-?[0-9.]+)")
    assert np.isfinite(mse) and -1.0 <= ss <= 1.0


# ------------------------------------------------ model directories of the JAX package


def drawn(module, rng, *args, **kw):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init({"params": key}, *args, **kw))["params"]
    return redraw(shapes, rng)


@pytest.fixture(scope="module")
def jax_whale_models(tmp_path_factory):
    """A whale model directory that the JAX package's functions wrote, at
    d = 2 (latent 512) and width 0.0078, with O(1) weights."""
    out = tmp_path_factory.mktemp("jax-whale") / "models"
    out.mkdir()
    rng = np.random.default_rng(0)
    _, _, stats = jwc.collect_whale_arrays(jwc.load_whale_dataset(None, None, None, synthetic_clips=4))
    model = jbigan.BiGAN(jbigan.whale_bigan_config(d=D))
    x, z = jnp.zeros((2, 256, 256, 1)), jnp.zeros((2, 1, 1, 512))
    a = {"call_type": jnp.eye(3)[:2]}
    pE, pG = drawn(model.encoder, rng, x, a), drawn(model.generator, rng, z, a)
    pD = drawn(model.discriminator, rng, x, z, a)
    tx = jgt.GANTrainer(model, jgt.GANTrainConfig(betas=(0.5, 0.9))).tx_eg
    st = jgt.GANState(params_E=pE, params_G=pG, vars_D={"params": pD, "batch_stats": {}},
                      opt_eg=tx.init({"E": pE, "G": pG}), opt_d=tx.init(pD), step=jnp.asarray(7, jnp.int32),
                      rng=jax.random.PRNGKey(0))
    jwc.save_whale_bigan(str(out / "whale-bigan.tar"), st, stats, meta={"epoch": 1, "d": D})
    params = drawn(jclf.CNNClassifier(jclf.narw_classifier_config(3, width=WIDTH)), rng, x)
    jckpt.save_checkpoint(str(out / "whale-clf.tar"), {"params": params, "spect_mean": np.asarray(stats.mean),
                                                       "spect_std": np.asarray(stats.std)},
                          meta={"kind": "whale-clf", "width": WIDTH})
    vae = jvae.ConditionalVAE(jvae.whale_vae_config(d=D))
    vparams = {"encoder": drawn(vae.encoder, rng, x, a), "decoder": drawn(vae.decoder, rng, z, a)}
    jckpt.save_checkpoint(str(out / "whale-vae.tar"), {"params": vparams}, meta={"kind": "vae-whale", "d": D})
    for f in out.iterdir():
        assert checkpoint_format(str(f)) == "jax"
    return out


def test_jax_whale_dir_gives_the_jax_scripts_cf_tallies(jax_whale_models, monkeypatch):
    """The port's ``whale_cf_score`` on the JAX package's model directory,
    its class draws those of the JAX script (``split`` of the seed's key a
    batch, ``categorical`` over the other two classes), prints the JAX
    script's tallies."""
    argv = ("--model-dir", jax_whale_models, "--bigan-ft", "whale-bigan.tar", "--vae", "whale-vae.tar",
            "--batch-size", 2, *WHALE)
    want = run_jax("whale_cf_score.py", *argv)
    key = [jax.random.PRNGKey(0)]

    def jax_draws(rng, current):
        key[0], k = jax.random.split(key[0])
        logits = jnp.where(jax.nn.one_hot(jnp.asarray(current.numpy()), 3, dtype=bool), -jnp.inf, 0.0)
        return torch.from_numpy(np.array(jax.random.categorical(k, logits, axis=-1))).long()

    monkeypatch.setattr(whale_cf_score, "draw_new_classes", jax_draws)
    got = run("whale_cf_score", *argv)
    tallies = [dict(re.findall(r"(\w+): call-type cf accuracy = ([0-9.]+)", t)) for t in (got, want)]
    assert set(tallies[0]) == {"bigan", "bigan_ft", "vae"}
    assert tallies[0] == tallies[1]


def test_jax_whale_dir_scores_and_resumes(jax_whale_models, tmp_path):
    acc = numbers(run("whale_generator_score", "--model-dir", jax_whale_models, "--n", 4, "--batch-size", 2),
                  r"generated call-type accuracy: ([0-9.]+)")
    assert len(acc) == 1 and 0.0 <= acc[0] <= 1.0
    out = tmp_path / "resume"
    out.mkdir()
    (out / "whale-bigan.tar").write_bytes((jax_whale_models / "whale-bigan.tar").read_bytes())
    text = run("train_whale_bigan", "--output-path", out, "--steps", 2, "--resume", "--d", D,
               "--batch-size", BATCH, *WHALE)
    assert "resumed from" in text and "at epoch 1 (step 7)" in text
    state, meta = load_train_state(str(out / "whale-bigan.tar"), "cpu")
    assert checkpoint_format(str(out / "whale-bigan.tar")) == "torch"
    assert state["trainer"]["step"] == 7 + 9 // BATCH and meta["epoch"] == 2


@pytest.fixture(scope="module")
def jax_esrf_model(tmp_path_factory):
    """An ESRF model file of the JAX package (E, G and the statistics of
    the stand-in's training windows), at d = 2 with O(1) weights."""
    out = tmp_path_factory.mktemp("jax-esrf")
    rng = np.random.default_rng(1)
    spects = np.concatenate([b["audio"] for b in JStation(synthetic_recordings=6).stream(batch_size=32)])
    stats = JStats.compute(jnp.asarray(spects))
    model = jbigan.BiGAN(jbigan.esrf_bigan_config(d=D))
    x, z = jnp.zeros((2, 512, 512, 1)), jnp.zeros((2, 1, 1, 512))
    a = {"has_boat": jnp.eye(2), "closest_boat": jnp.zeros((2,))}
    tree = {"params_E": drawn(model.encoder, rng, x, a), "params_G": drawn(model.generator, rng, z, a),
            "spect_mean": np.asarray(stats.mean), "spect_std": np.asarray(stats.std)}
    jckpt.save_checkpoint(str(out / "esrf-bigan.tar"), tree, meta={"kind": "bigan-esrf", "d": D})
    return out


def test_jax_esrf_file_gives_the_jax_tools_quality(jax_esrf_model, monkeypatch):
    from imagecfgen_tpu.utils import heartbeat

    class Quiet:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(heartbeat, "Heartbeat", Quiet)
    # 6 recordings: the validation split holds a boat recording (10 windows) and a quiet one
    argv = ("--model-dir", jax_esrf_model, "--synthetic-recordings", 6, "--batch-size", BATCH)
    want = run_jax("tools/esrf_quality.py", *argv)
    got = run("esrf_quality", *argv)
    pattern = r"validation windows: (\d+) \(no-boat (\d+), boat (\d+)\)"
    assert re.search(pattern, got).groups() == re.search(pattern, want).groups()
    rec = r"reconstruction: mse=([0-9.]+) ssim=(-?[0-9.]+)"
    (mse_t, ss_t), (mse_j, ss_j) = (tuple(map(float, re.search(rec, t).groups())) for t in (got, want))
    np.testing.assert_allclose(mse_t, mse_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss_t, ss_j, rtol=2e-3, atol=1e-4)
    ratios = r"median (-?[0-9.]+) \(want [<>] 1\), control-band (-?[0-9.]+)"
    rt, rj = numbers(got, ratios), numbers(want, ratios)
    assert len(rt) == len(rj) == 4  # both directions
    np.testing.assert_allclose(rt, rj, rtol=2e-3, atol=1e-3)
