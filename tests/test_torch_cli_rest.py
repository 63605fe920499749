"""The port's last MNIST and AudioMNIST CLIs (``python -m
imagecfgen_torch.cli.<name>``) on the CPU, at a small size: the four figure
CLIs on narrow MNIST models (every width an eighth, latent 32) and a 32 + 16
row dataset; the audio VAE (d = 2), the two VAE scores, the BiGAN
fine-tune and the unconditional GAN on the stand-in cut to 4 subjects at two
runs (40 training and 40 validation clips), classifiers at width 0.0625.

- each parser takes every option string of its JAX script's parser, with the
  same defaults, plus ``--device``; ``--help`` runs with no card and with
  matplotlib, PIL and torchaudio unimportable; without ``--device cpu`` and
  with no card every CLI raises before it runs;
- on a model directory the JAX package's functions wrote, the figure CLIs
  draw the JAX scripts' numbers (recorded from matplotlib's ``plot``,
  ``bar`` and ``imshow`` in the JAX scripts, from the port's panel
  functions here): the thickness sweep's images and the sweep's class
  probabilities to 1e-4 of max(1, |value|) (the engine's abduction is
  deterministic here: flows, and a parentless categorical kept), the mixture
  path's probabilities and entropy, the best counterfactual, its metric and
  its probabilities to 1e-4 absolute (probabilities, SSIM and images in
  [-1, 1]);
- the audio VAE scores on a JAX-written directory, the JAX script and the
  port's CLI making the same draws (the port's SCM calls and ``z`` take what
  the JAX script's key chain draws): the same resampled classes,
  counterfactual or sampled attributes and printed accuracy, and encoder
  means and decodes equal to 1e-5 of max(1, |value|); the score's validation
  images equal the JAX pipeline's to 2e-3 of their range (the two STFTs
  differ by up to 5e-4 in image units where the power is near zero), so for
  the end-to-end comparison both normalise the port's spectrograms;
- both training CLIs resume bit for bit (the VAE also from a resumable JAX
  file); the fine-tune moves E only and writes a file the port loads.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import optax
import pytest
import torch
from test_torch_cli_audio import BATCH, D, N_TRAIN, WIDTH, drawn, first_subjects
from test_torch_cli_mnist import write_dataset
from test_torch_gan_trainer import jax_state
from test_torch_train_layers import narrow_config, narrow_plan, redraw

from imagecfgen_tpu.cli import audio_common as jaudio
from imagecfgen_tpu.cli import common as jcommon
from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_SPEC
from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
from imagecfgen_tpu.data import audio_mnist as jdata
from imagecfgen_tpu.data import mnist as jmnist
from imagecfgen_tpu.metrics import scores as jscores
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_tpu.models import vae as jvae
from imagecfgen_tpu.scm.audio_mnist import AudioMNISTAttributeSCM as JAudioSCM
from imagecfgen_tpu.scm.audio_mnist import build_audio_mnist_graph as j_audio_graph
from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
from imagecfgen_torch.cli import audio_common as taudio
from imagecfgen_torch.cli import common as tcommon
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.data import audio_mnist as tdata
from imagecfgen_torch.metrics import scores as tscores
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import vae as tvae
from imagecfgen_torch.models.vae import VAEDecoder, VAEEncoder
from imagecfgen_torch.scm.audio_mnist import CARDINALITIES
from imagecfgen_torch.scm.audio_mnist import AudioMNISTAttributeSCM as TAudioSCM

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402  (after the backend is chosen)

REPO = Path(__file__).resolve().parents[1]
FIGURES = ("display_thickness", "causal_graph_cf", "uncertainty_evolution", "cf_automatic_mix")
AUDIO = ("train_audio_mnist_vae", "audiomnist_vae_score", "audiomnist_vae_generator_score",
         "finetune_audio_mnist_bigan", "train_audio_gan")
CLIS = FIGURES + AUDIO
N, N_TEST = 32, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its 128x128 convs on
    several threads, beside the suite's other workers, oversubscribe the
    host's cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ------------------------------------------------------------ the parsers


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x")["parser"]
    assert _options(tparser) == _options(jparser) | {"--device"}
    port = {a.dest: a for a in tparser._actions}
    for a in jparser._actions:
        t = port[a.dest]
        assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
            a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest
    assert tparser.parse_args([]).device == "cuda"


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
    monkeypatch.chdir(tmp_path)
    argv = {"train_audio_mnist_vae": ["--output-path", "out"], "train_audio_gan": ["--output-path", "out"]}
    argv = argv.get(name, ["--output", "out"] if name in FIGURES else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"imagecfgen_torch.cli.{name}").main(argv)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- the MNIST figure CLIs


def narrow_vae(mod):
    return dataclasses.replace(narrow_config(mod, "mnist"), init_std=1e-4)


def narrow_classifier(mod):
    full = mod.mnist_classifier_config()
    return dataclasses.replace(full, plan=narrow_plan(full.plan, 8, keep_last=False))


@contextlib.contextmanager
def narrow_models():
    """Both packages build the narrow configs where their CLIs build theirs."""
    configs = {(tbigan, "mnist_bigan_config"): narrow_config(tbigan, "mnist"),
               (jbigan, "mnist_bigan_config"): narrow_config(jbigan, "mnist"),
               (tvae, "mnist_vae_config"): narrow_vae(tbigan), (jvae, "mnist_vae_config"): narrow_vae(jbigan),
               (tclf, "mnist_classifier_config"): narrow_classifier(tclf),
               (jclf, "mnist_classifier_config"): narrow_classifier(jclf)}
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), cfg in configs.items():
            mp.setattr(mod, name, lambda cfg=cfg: cfg)
        yield


@pytest.fixture(scope="module")
def jax_mnist(tmp_path_factory):
    """A dataset and a model directory that the JAX package's functions
    wrote (BiGAN, SCM, both classifiers, VAE), narrow, with O(1) weights."""
    root = tmp_path_factory.mktemp("figures")
    data, models = root / "data", root / "models"
    write_dataset(data, N, N_TEST, 5)
    models.mkdir()
    _, st, rng = jax_state("mnist", 0, {})
    x_np, attrs = jmnist.load_mnist_arrays(str(data), "train")
    jcommon.save_bigan(str(models / "mnist-bigan.tar"), st, JScaler.fit(J_SPEC, attrs))
    i, s = attrs["intensity"], attrs["slant"]
    graph = j_build(i.min(), i.max(), s.min(), s.max())
    jcommon.save_attribute_scm(str(models / "mnist-attribute-scm.tar"),
                               JSCM(graph, *jax.device_get(graph.init(jax.random.PRNGKey(1)))))
    clf = jclf.CNNClassifier(narrow_classifier(jclf))
    for name in ("mnist_clf.tar", "mnist_clf_raw.tar"):
        params = redraw(clf.init(jax.random.PRNGKey(2), jnp.zeros((2, 28, 28, 1)))["params"], rng)
        jckpt.save_checkpoint(str(models / name), {"params": params}, meta={"kind": "mnist-clf"})
    vae = jvae.ConditionalVAE(narrow_vae(jbigan))
    x, a = jnp.zeros((2, 28, 28, 1)), {k: jnp.asarray(v[:2]) for k, v in attrs.items()}
    a = JScaler.fit(J_SPEC, attrs).scale(a)
    key = jax.random.PRNGKey(3)
    vparams = {"encoder": redraw(vae.encoder.init(key, x, a)["params"], rng),
               "decoder": redraw(vae.decoder.init(key, jnp.zeros((2, 1, 1, 32)), a)["params"], rng)}
    jckpt.save_checkpoint(str(models / "mnist-vae.tar"),
                          {"params": vparams, "scaler": JScaler.fit(J_SPEC, attrs).state_dict()},
                          meta={"kind": "vae-mnist"})
    for f in models.iterdir():
        assert checkpoint_format(str(f)) == "jax"
    return data, models


@contextlib.contextmanager
def recording():
    """What either package draws: ``{"jax": [(kind, args)], "port": [...]}``,
    from matplotlib's ``plot``/``bar``/``imshow`` and from the port's panel
    functions and grid writers (which still draw)."""
    seen = {"jax": [], "port": []}

    def wrap(owner, name, pkg, kind, real):
        def record(*args, **kw):
            seen[pkg].append((kind, [np.asarray(a) for a in args[1 if owner is matplotlib.axes.Axes else 0:]]))
            return real(*args, **kw)
        return record

    with pytest.MonkeyPatch.context() as mp:
        for name in ("plot", "bar", "imshow", "set_title"):
            mp.setattr(matplotlib.axes.Axes, name,
                       wrap(matplotlib.axes.Axes, name, "jax", name, getattr(matplotlib.axes.Axes, name)))
        for name, kind in (("curve_panel", "plot"), ("bar_panel", "bar"), ("image_panel", "imshow")):
            mp.setattr(tcommon, name, wrap(tcommon, name, "port", kind, getattr(tcommon, name)))
        for pkg, mod in (("jax", jcommon), ("port", tcommon)):
            mp.setattr(mod, "save_grid_png", wrap(mod, "save_grid_png", pkg, "grid", mod.save_grid_png))
        yield seen


def figure(name, data, models, tmp_path, *argv):
    """The JAX script and the port's CLI on the same files: what each drew,
    and the port's PNG read back."""
    with narrow_models(), recording() as seen:
        run_jax(name, "--data-dir", data, "--model-dir", models, "--output", tmp_path / "jax.png", *argv)
        log = run(name, "--data-dir", data, "--model-dir", models, "--output", tmp_path / "port.png", *argv)
    pix = tcommon.read_png(str(tmp_path / "port.png"))
    assert np.unique(pix).size > 2, "a blank figure"
    return seen, pix, log


def close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (msg, np.abs(got - want).max())


def test_display_thickness_draws_the_jax_sweep(jax_mnist, tmp_path):
    data, models = jax_mnist
    seen, pix, _ = figure("display_thickness", data, models, tmp_path, "--n-points", 6, "--image-index", 2)
    (jgrid,) = [args for kind, args in seen["jax"] if kind == "grid"]  # the JAX grid draws with imshow too
    (pgrid,) = [args for kind, args in seen["port"] if kind == "grid"]
    close(pgrid[1][0], jgrid[1][0], 1e-4, "the sweep's counterfactuals")  # rows[0]: (6, 28, 28)
    assert pix.shape == (28, 6 * 28)


def test_causal_graph_cf_draws_the_jax_probabilities(jax_mnist, tmp_path):
    data, models = jax_mnist
    seen, pix, log = figure("causal_graph_cf", data, models, tmp_path, "intensity", "--n-images", 3,
                            "--n-points", 5)
    want = np.stack([args[1] for kind, args in seen["jax"] if kind == "plot"]).reshape(3, 10, 5)
    got = np.stack([args[0] for kind, args in seen["port"]])
    close(got, want, 1e-4, "class probabilities over do(intensity)")
    assert "do(intensity)" in log and pix.shape == (96, 3 * 160 + 2 * 4, 3)


def test_uncertainty_evolution_draws_the_jax_path(jax_mnist, tmp_path):
    data, models = jax_mnist
    seen, pix, _ = figure("uncertainty_evolution", data, models, tmp_path, "--n-points", 7,
                          "--contrastive-steps", 3, "--target-class", 5, "--clf-type", "raw")
    jplots = [args[1] for kind, args in seen["jax"] if kind == "plot"]
    pcurves = [args[0] for kind, args in seen["port"] if kind == "plot"]
    close(np.atleast_2d(pcurves[0]), np.stack(jplots[:2]), 1e-4, "class probabilities")
    close(np.atleast_2d(pcurves[1]), np.stack(jplots[2:]), 1e-4, "entropy")
    jimages = [args[0] for kind, args in seen["jax"] if kind == "imshow"]
    pimages = [args[0] for kind, args in seen["port"] if kind == "imshow"]
    close(pimages[0], jimages[0], 1e-6, "the original")
    assert [p.shape for p in pimages] == [(28, 28), (28, 28, 3), (28, 28, 3)]
    assert pix.shape == (96, 2 * 160 + 3 * 84 + 4 * 4, 3)


@pytest.mark.parametrize("model", ["vae", "bigan"])
def test_cf_automatic_mix_draws_the_jax_counterfactual(jax_mnist, tmp_path, model):
    data, models = jax_mnist
    orig = int(jmnist.load_mnist_arrays(str(data), "test")[1]["digit"][0].argmax())  # one the test split holds
    seen, pix, log = figure("cf_automatic_mix", data, models, tmp_path, "--model", model, "--sample-points", 20,
                            "--original-digit", orig, "--target-digit", (orig + 1) % 10)
    jimages = [args[0] for kind, args in seen["jax"] if kind == "imshow"]
    pimages = [args[0] for kind, args in seen["port"] if kind == "imshow"]
    for what, got, want in zip(("original", "best counterfactual", "difference"), pimages, jimages):
        close(got, want, 1e-4, what)
    (jbar,) = [args[1] for kind, args in seen["jax"] if kind == "bar"]
    (pbar,) = [args[0] for kind, args in seen["port"] if kind == "bar"]
    close(pbar, jbar, 1e-4, "probabilities")
    (jtitle,) = [str(args[0]) for kind, args in seen["jax"] if kind == "set_title" and "metric=" in str(args[0])]
    metric = float(re.search(r"best ssim = ([0-9.]+)", log).group(1))  # both to four places
    assert abs(metric - float(re.search(r"metric=([0-9.]+)", jtitle).group(1))) <= 1.5e-4
    assert pix.shape == (96, 3 * 84 + 160 + 3 * 4, 3)


# ------------------------------------------------------------ AudioMNIST


@pytest.fixture(scope="module")
def small_data():
    """Both packages' ``load_audio_dataset`` return the cut stand-in."""
    jd, td = first_subjects(jdata.AudioMNISTData(None, 2)), first_subjects(tdata.AudioMNISTData(None, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(taudio, "load_audio_dataset", lambda zip_path, synthetic_runs=4: td)
        mp.setattr(jaudio, "load_audio_dataset", lambda zip_path, synthetic_runs=4: jd)
        yield jd, td


def same(a, b, path):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            same(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(b):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_train_audio_mnist_vae_resumes_bit_for_bit(small_data, tmp_path):
    args = ("--d", D, "--batch-size", BATCH, "--checkpoint-every", 1)
    straight, split = tmp_path / "straight", tmp_path / "split"
    log = run("train_audio_mnist_vae", "--output-path", straight, "--steps", 2, *args)
    assert len(re.findall(r"-elbo=[-0-9.]+ \([0-9.]+ steps/s\)", log)) == 2
    run("train_audio_mnist_vae", "--output-path", split, "--steps", 1, *args)
    log = run("train_audio_mnist_vae", "--output-path", split, "--steps", 2, "--resume", *args)
    assert f"at epoch 1 (step {N_TRAIN // BATCH})" in log
    got, stats, meta = taudio.load_audio_vae_state(str(split / "audio-mnist-vae.tar"), "cpu")
    want, _, _ = taudio.load_audio_vae_state(str(straight / "audio-mnist-vae.tar"), "cpu")
    assert meta["kind"] == "vae-audio-mnist" and meta["epoch"] == 2 and meta["d"] == D and meta["carries_rng"]
    assert got["step"] == 2 * (N_TRAIN // BATCH) and tuple(stats.mean.shape) == (1, 1, 128)
    same(got, want, "state")
    model, _, _ = taudio.load_audio_vae_model(str(split / "audio-mnist-vae.tar"), "cpu")
    assert model.cfg.enc_plan[0][1] == D


@pytest.mark.parametrize("mode", ["gan", "wgan"])
def test_train_audio_gan_resumes_bit_for_bit(small_data, tmp_path, mode):
    args = ("--generator-size", D, "--batch-size", BATCH, "--checkpoint-every", 1, "--loss-mode", mode,
            "--d-updates-per-g-update", 2, "--discriminator-weight-decay", 0.01)
    straight, split = tmp_path / "straight", tmp_path / "split"
    run("train_audio_gan", "--output-path", straight, "--steps", 2, *args)
    run("train_audio_gan", "--output-path", split, "--steps", 1, *args)
    log = run("train_audio_gan", "--output-path", split, "--steps", 2, "--resume", *args)
    assert f"at epoch 1 (step {N_TRAIN // BATCH})" in log
    assert len(re.findall(r"loss_G=[-0-9.]+ loss_D=[-0-9.]+ \([0-9.]+ steps/s", log)) == 1
    got, stats, meta = taudio.load_audio_gan(str(split / f"audio-gan-{mode}.tar"), "cpu")
    want, _, _ = taudio.load_audio_gan(str(straight / f"audio-gan-{mode}.tar"), "cpu")
    assert meta["kind"] == f"uncond-gan-{mode}" and meta["epoch"] == 2 and tuple(stats.std.shape) == (1, 1, 128)
    steps = 2 * (N_TRAIN // BATCH)
    assert got["step"] == steps and got["opt_d"]["count"] == steps and got["opt_g"]["count"] == steps // 2
    same(got, want, "state")


@pytest.fixture(scope="module")
def jax_audio(tmp_path_factory, small_data):
    """A model directory the JAX package's functions wrote: a resumable VAE
    (d = 2, with its Adam state and statistics), the attribute SCM and the
    digit classifier (width 0.0625), O(1) weights."""
    jd, _ = small_data
    out = tmp_path_factory.mktemp("jax-vae") / "models"
    out.mkdir()
    rng = np.random.default_rng(7)
    _, _, stats = jaudio.prepare_training_arrays(jd)
    x, z = jnp.zeros((2, 128, 128, 1)), jnp.zeros((2, 1, 1, 512))
    a = {k: jnp.zeros((2, n)).at[:, 0].set(1.0) for k, n in CARDINALITIES.items()}
    vae = jvae.ConditionalVAE(jvae.audio_mnist_vae_config(d=D))
    params = {"encoder": drawn(vae.encoder, rng, x, a), "decoder": drawn(vae.decoder, rng, z, a)}
    jckpt.save_checkpoint(str(out / "audio-mnist-vae.tar"),
                          {"params": params, "opt": optax.adam(1e-4).init(params), "step": jnp.asarray(3),
                           "rng": jax.random.PRNGKey(9), "spect_mean": np.asarray(stats.mean),
                           "spect_std": np.asarray(stats.std)},
                          meta={"kind": "vae-audio-mnist", "epoch": 1, "d": D, "carries_rng": True})
    graph = j_audio_graph()
    jaudio.save_audio_scm(str(out / "audio-mnist-attribute-scm.tar"),
                          JAudioSCM(graph, *jax.device_get(graph.init(jax.random.PRNGKey(1)))))
    cparams = drawn(jclf.CNNClassifier(jclf.audio_mnist_classifier_config(10, width=WIDTH)), rng, x)
    jckpt.save_checkpoint(str(out / "audio-mnist-digit-clf.tar"),
                          {"params": cparams, "spect_mean": np.asarray(stats.mean), "spect_std": np.asarray(stats.std)},
                          meta={"kind": "audio-mnist-clf", "attribute": "digit", "n_classes": 10, "width": WIDTH})
    return out, vae, params, stats


@contextlib.contextmanager
def vae_calls():
    """The port's VAE encoder and decoder calls: ``{"enc": [(x, a, mean)],
    "dec": [(z, a, image)]}``."""
    calls = {"enc": [], "dec": []}
    enc, dec = VAEEncoder.forward, VAEDecoder.forward

    def enc_rec(self, x, attrs, train=False):
        out = enc(self, x, attrs, train)
        calls["enc"].append((x.numpy().copy(), {k: v.numpy().copy() for k, v in attrs.items()}, out[0].numpy()))
        return out

    def dec_rec(self, z, attrs, train=False, **kw):
        out = dec(self, z, attrs, train, **kw)
        calls["dec"].append((z.numpy().copy(), {k: v.numpy().copy() for k, v in attrs.items()}, out.numpy()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VAEEncoder, "forward", enc_rec)
        mp.setattr(VAEDecoder, "forward", dec_rec)
        yield calls


def check_vae_calls(calls, vae, params):
    """Each recorded call against the JAX module on the same inputs."""
    assert calls["dec"]
    for x, a, mean in calls["enc"]:
        want, _ = vae.encoder.apply({"params": params["encoder"]}, jnp.asarray(x), a)
        close(mean, np.asarray(want), 1e-5, "encoder mean")
    for z, a, img in calls["dec"]:
        want = vae.decoder.apply({"params": params["decoder"]}, jnp.asarray(z), a)
        close(img, np.asarray(want), 1e-5, "decode")


class JaxDraws:
    """The JAX scores' key chain (``rng, k1, k2 = split(rng, 3)`` a round),
    replayed into the port's SCM calls as the Gumbels and normals the JAX
    script draws from the same keys, so that both make the same draws."""

    def __init__(self, seed: int):
        self.rng, self.k2 = jax.random.PRNGKey(seed), None
        self.graph = j_audio_graph()  # the structure only

    def split(self):
        self.rng, k1, self.k2 = jax.random.split(self.rng, 3)
        return k1

    def gumbels(self, keys, names, b):
        return {v: torch.from_numpy(np.array(jax.random.gumbel(k, (b, CARDINALITIES[v]))))
                for k, v in zip(keys, names)}

    def abduction(self, obs):
        """``sample_cf(k2, obs)``'s Gumbels: the fill draws nothing (every
        node observed); ``recover_noise`` one key per node, in insertion
        order, which only the conditional nodes use."""
        names = [v for v in self.graph.modules if v in obs]
        _, k_noise = jax.random.split(self.k2)
        b = next(iter(obs.values())).reshape(-1).shape[0]
        return self.gumbels(jax.random.split(k_noise, len(names)), names, b)

    def ancestral(self, k1, b):
        """``scm.sample(k1, n=b)``'s Gumbels: one key per node, in
        topological order."""
        order = self.graph.top_sort()
        return self.gumbels(jax.random.split(k1, len(order)), order, b)


@contextlib.contextmanager
def jax_vae_calls():
    """The JAX VAE modules' eager calls: ``{"enc": [(x, a, mean)], "dec":
    [(z, a, image)]}``."""
    calls = {"enc": [], "dec": []}

    def recorder(kind):
        def apply(self, variables, z, attrs, *args, **kw):
            out = flax.linen.Module.apply(self, variables, z, attrs, *args, **kw)
            calls[kind].append((np.asarray(z), {k: np.asarray(v) for k, v in attrs.items()},
                                np.asarray(out[0] if kind == "enc" else out)))
            return out
        return apply

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae.VAEEncoder, "apply", recorder("enc"))
        mp.setattr(jvae.VAEDecoder, "apply", recorder("dec"))
        yield calls


def recorded(owner, name, seen, mp, inject=None):
    """``owner.name`` wrapped: ``inject(args, kw)`` may change its call, and
    its outputs are appended to ``seen`` as numpy."""
    real = getattr(owner, name)

    def call(*args, **kw):
        if inject is not None:
            args, kw = inject(args, kw)
        out = real(*args, **kw)
        seen.append({k: np.asarray(v).reshape(-1) for k, v in out.items()} if isinstance(out, dict)
                    else np.asarray(out).reshape(-1))
        return out

    mp.setattr(owner, name, call)


def same_draws(got, want, what):
    assert len(got) == len(want) > 0, what
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w), what
            for k in w:
                assert np.array_equal(g[k], w[k]), f"{what}: {k}"
        else:
            assert np.array_equal(g, w), what


def test_vae_score_on_a_jax_model_dir(jax_audio, small_data):
    """The JAX script and the port's CLI on the same directory and the same
    draws (the port's SCM calls take the Gumbels the JAX key chain gives):
    the same resampled classes and counterfactual attributes, encoder means
    and decodes to 1e-5, and the same printed accuracy. Both normalise the
    port's spectrograms here (the JAX script's are swapped in), so that the
    two STFTs' difference, held apart below, does not enter."""
    models, vae, params, stats = jax_audio
    jd, td = small_data
    argv = ("--model-dir", models, "--batch-size", 32, "--mc-rounds", 2, "--seed", 3)
    spects, jattrs, _ = jd.all_spectrograms(excluded_runs=jd.validation_excluded_runs)
    pspects, pattrs, _ = td.all_spectrograms(excluded_runs=td.validation_excluded_runs, device="cpu")
    same_draws([pattrs], [jattrs], "validation attributes")
    jseen, pseen = {"new": [], "cf": []}, {"new": [], "cf": []}
    with jax_vae_calls() as jcalls, pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "all_spectrograms", lambda **kw: (pspects.numpy(), jattrs, None))
        recorded(jscores, "resample_excluding", jseen["new"], mp)
        recorded(JAudioSCM, "sample_cf", jseen["cf"], mp)
        jlog = run_jax("audiomnist_vae_score", *argv)
    draws = JaxDraws(3)

    def resample(args, kw):  # (graph, params, state, rng, node, obs)
        k1, node, obs = draws.split(), args[4], args[5]
        b = obs[node].reshape(-1).shape[0]
        return args, {**kw, "gumbel": torch.from_numpy(np.array(jax.random.gumbel(k1, (b, CARDINALITIES[node]))))}

    with vae_calls() as calls, pytest.MonkeyPatch.context() as mp:
        recorded(tscores, "resample_excluding", pseen["new"], mp, resample)
        recorded(TAudioSCM, "sample_cf", pseen["cf"], mp,
                 lambda args, kw: (args, {**kw, "noise": draws.abduction(args[2])}))
        log = run("audiomnist_vae_score", *argv)
    same_draws(pseen["new"], jseen["new"], "resampled classes")
    same_draws(pseen["cf"], jseen["cf"], "counterfactual attributes")
    assert [c[0].shape[0] for c in calls["enc"]] == [32, 8] and len(calls["dec"]) == 4
    for kind in ("enc", "dec"):
        assert len(calls[kind]) == len(jcalls[kind]), kind
        for (x, a, out), (jx, ja, jout) in zip(calls[kind], jcalls[kind]):
            close(x, jx, 1e-5, f"{kind} input")
            same_draws([{k: v.argmax(-1) for k, v in a.items()}], [{k: v.argmax(-1) for k, v in ja.items()}],
                       f"{kind} attributes")
            close(out, jout, 1e-5, "encoder mean" if kind == "enc" else "decode")
    acc = re.search(r"vae digit cf accuracy: ([0-9.]+)", log).group(1)
    assert acc == re.search(r"vae digit cf accuracy: ([0-9.]+)", jlog).group(1)
    # the port's own validation images against the JAX pipeline's
    want = np.asarray(stats.spect_to_img(jnp.asarray(spects)))[..., None]
    got = np.concatenate([c[0] for c in calls["enc"]])
    assert np.abs(got - want).max() <= 2e-3 * (want.max() - want.min())


def test_vae_generator_score_on_a_jax_model_dir(jax_audio, monkeypatch):
    """The JAX script and the port's CLI on the same directory and the same
    draws (the port's ``scm.sample`` takes the JAX key chain's Gumbels, and
    its ``z`` that chain's normals): the same sampled attributes, decodes
    equal to the JAX decoder's on them to 1e-5, and the same printed
    accuracy."""
    models, vae, params, _ = jax_audio
    # the JAX script builds the classifier at width 1: it reads this one at its own width
    wide = jclf.audio_mnist_classifier_config
    monkeypatch.setattr(jclf, "audio_mnist_classifier_config", lambda n, width=WIDTH: wide(n, width=width))
    argv = ("--model-dir", models, "--n", 20, "--batch-size", 16, "--mc-rounds", 2, "--seed", 4)
    jseen, pseen, zs = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        recorded(JAudioSCM, "sample", jseen, mp)
        jlog = run_jax("audiomnist_vae_generator_score", *argv)
    draws, randn = JaxDraws(4), torch.randn

    def sample(args, kw):  # (self, rng, n=b, device=...)
        k1 = draws.split()
        zs.append(torch.from_numpy(np.array(jax.random.normal(draws.k2, (kw["n"], 1, 1, 512)))))
        return args, {**kw, "noise": draws.ancestral(k1, kw["n"])}

    def injected_randn(*shape, generator=None, **kw):
        return zs[-1] if generator is not None else randn(*shape, generator=generator, **kw)

    with vae_calls() as calls, pytest.MonkeyPatch.context() as mp:
        recorded(TAudioSCM, "sample", pseen, mp, sample)
        mp.setattr(torch, "randn", injected_randn)
        log = run("audiomnist_vae_generator_score", *argv)
    same_draws(pseen, jseen, "sampled attributes")
    assert [c[0].shape[0] for c in calls["dec"]] == [16, 4, 16, 4] and not calls["enc"]
    for (z, a, _), want_z, samp in zip(calls["dec"], zs, pseen):
        assert np.array_equal(z, want_z.numpy())
        same_draws([{k: v.argmax(-1) for k, v in a.items()}], [samp], "decoded attributes")
    check_vae_calls(calls, vae, params)
    acc = re.search(r"vae generated digit accuracy: ([0-9.]+)", log).group(1)
    assert acc == re.search(r"vae generated digit accuracy: ([0-9.]+)", jlog).group(1)


def test_train_audio_mnist_vae_resumes_a_jax_file(jax_audio, tmp_path):
    models, _, params, _ = jax_audio
    shutil.copy(models / "audio-mnist-vae.tar", tmp_path / "audio-mnist-vae.tar")
    log = run("train_audio_mnist_vae", "--output-path", tmp_path, "--steps", 2, "--d", D, "--batch-size", BATCH)
    assert "resumed" not in log
    shutil.copy(models / "audio-mnist-vae.tar", tmp_path / "audio-mnist-vae.tar")
    log = run("train_audio_mnist_vae", "--output-path", tmp_path, "--steps", 2, "--d", D, "--batch-size", BATCH,
              "--resume")
    assert "at epoch 1 (step 3)" in log
    state, _, meta = taudio.load_audio_vae_state(str(tmp_path / "audio-mnist-vae.tar"), "cpu")
    assert checkpoint_format(str(tmp_path / "audio-mnist-vae.tar")) == "torch"
    assert state["step"] == 3 + N_TRAIN // BATCH and state["opt"]["count"] == N_TRAIN // BATCH
    assert meta["epoch"] == 2


def test_finetune_moves_the_encoder_only(small_data, tmp_path, monkeypatch):
    models = tmp_path / "models"
    run("train_audio_mnist_bigan", "--output-path", models, "--d", D, "--batch-size", BATCH, "--init-std", 0.01,
        "--steps", 1)
    monkeypatch.chdir(tmp_path)
    log = run("finetune_audio_mnist_bigan", "--model-file", models / "audio-mnist-bigan.tar", "--steps", 1,
              "--batch-size", BATCH, "--lr", 1e-3, "--metric", "ssim")
    assert re.search(r"ssim=[0-9.]+ latent=[0-9.]+ \([0-9.]+ steps/s\)", log)
    before, stats, _ = taudio.load_audio_bigan(str(models / "audio-mnist-bigan.tar"), "cpu")
    after, stats2, meta = taudio.load_audio_bigan("audio-mnist-bigan-finetuned-ssim.tar", "cpu")
    assert meta["finetuned"] == "ssim" and meta["d"] == D and torch.equal(stats.mean, stats2.mean)
    for part in ("G", "D"):
        same(after[part], before[part], part)
    moved = [k for k in before["E"] if not torch.equal(before["E"][k], after["E"][k])]
    assert set(moved) == set(before["E"]), f"unmoved: {set(before['E']) - set(moved)}"
    model, _, _ = taudio.load_audio_bigan_model("audio-mnist-bigan-finetuned-ssim.tar", "cpu")
    assert model.cfg.enc_plan[0][1] == D
