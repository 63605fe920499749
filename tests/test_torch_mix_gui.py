"""The port's attribute-slider GUI (``imagecfgen_torch/cli/mnist_mix_vae_gui.py``)
against the JAX script ``mnist_mix_vae_gui.py``, run verbatim through
``runpy`` under matplotlib's Agg backend on the same files (the JAX
package's, which the port reads): its ``cf_image`` and ``mix_image``
closures and the image its slider callback renders, against the port's
``MixGui`` at the same slider values, and the port's headless grid against
the JAX closures at the grid's positions.

The files hold the JAX trainer's initial state with E's and G's weights
drawn anew at N(0, 1/fan-in) (embeddings N(0, 1), biases N(0, 0.1)), so the
images are O(1), not the initialiser's near-zero ones.

No draw reaches these images: every continuous attribute is intervened, and
the digit, observed, has no intervened ancestor, so its abduction gives it
back whatever the Gumbels. Tolerances are the engine's
(``tests/test_torch_cf_engine.py``): rtol 1e-4 and atol 2e-4 (the five-conv
encoder and five-deconv generator summed in another order).
"""
import os
import runpy
import sys

import numpy as np
import pytest

from imagecfgen_torch.cli import mnist_mix_vae_gui as port_gui
from imagecfgen_torch.cli.common import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_TOL = 2e-4
INDEX = 1


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=IMG_TOL)


def _redraw(params, rng):
    import jax

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = (1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name
               else 1.0 if "embed" in name else 0.1)
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


@pytest.fixture(scope="module")
def gui_dirs(tmp_path_factory):
    """A small dataset and the JAX package's BiGAN and attribute-SCM files."""
    import jax

    from imagecfgen_tpu.cli.common import save_attribute_scm, save_bigan
    from imagecfgen_tpu.core.attributes import MNIST_SPEC, AttributeScaler
    from imagecfgen_tpu.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM
    from imagecfgen_tpu.train.gan_trainer import GANTrainConfig, GANTrainer

    d = tmp_path_factory.mktemp("gui")
    rng = np.random.default_rng(0)
    n = 64
    t = rng.gamma(10, 1 / 5, n).astype(np.float32) + 0.5
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, n)).astype(np.float32)
    digit = rng.integers(0, 10, n)
    x = rng.uniform(0, 255, (n, 28, 28)).astype(np.float32)
    eye = np.eye(10, dtype=np.float32)
    np.save(d / "mnist-x-train.npy", x)
    np.save(d / "mnist-a-train.npy", np.concatenate([eye[digit], t[:, None], i[:, None], s[:, None]], axis=1))
    attrs = {"digit": eye[digit], "thickness": t, "intensity": i, "slant": s}
    state = GANTrainer(BiGAN(mnist_bigan_config()), GANTrainConfig(batch_size=16)).init_state(jax.random.PRNGKey(0))
    state = state.replace(params_E=_redraw(state.params_E, rng), params_G=_redraw(state.params_G, rng))
    save_bigan(str(d / "mnist-bigan.tar"), state, AttributeScaler.fit(MNIST_SPEC, attrs))
    scm = MNISTAttributeSCM.fit({"thickness": t, "intensity": i, "slant": s, "digit": digit}, steps=5, batch_size=n)
    save_attribute_scm(str(d / "mnist-attribute-scm.tar"), scm)
    return d


@pytest.fixture(scope="module")
def guis(gui_dirs):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import imagecfgen_tpu.cli.common as jcommon

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "clean_exit", lambda *a, **k: None)
        mp.setattr(jcommon, "install_cli_excepthook", lambda *a, **k: None)
        mp.setattr(sys, "argv", ["mnist_mix_vae_gui.py", "--data-dir", str(gui_dirs), "--model-dir",
                                 str(gui_dirs), "--image-index", str(INDEX)])
        g = runpy.run_path(os.path.join(REPO, "mnist_mix_vae_gui.py"), run_name="__main__")
    gui = port_gui.load_gui(str(gui_dirs), str(gui_dirs), image_index=INDEX, device="cpu")
    return g, gui


def test_ranges_and_digit_match(guis):
    g, gui = guis
    for name, (lo, hi, v0) in g["ranges"].items():
        np.testing.assert_allclose(gui.ranges[name], (lo, hi), rtol=1e-6)
        np.testing.assert_allclose(gui.values[name], v0, rtol=1e-6)
    assert gui.digit == g["orig_dig"]


SETTINGS = [("lo", "mid", "hi"), ("hi", "lo", "mid"), ("mid", "hi", "lo")]


@pytest.mark.parametrize("setting", SETTINGS, ids="-".join)
def test_cf_image_matches_jax(guis, setting):
    g, gui = guis
    vals = [_at(gui.ranges[k], where) for k, where in zip(port_gui.CONTINUOUS, setting)]
    close(gui.cf_image(*vals), g["cf_image"](*vals))


def _at(rng, where):
    lo, hi = rng
    return {"lo": lo, "mid": 0.5 * (lo + hi), "hi": hi}[where]


@pytest.mark.parametrize("v", [0.3, 1.0])
def test_mix_image_matches_jax(guis, v):
    g, gui = guis
    got = gui.mix_image(v)
    close(got, g["mix_image"](v))
    assert np.abs(got).max() > 0.1 and np.abs(got - gui.mix_image(0.0)).max() > 1e-3  # it moves


def test_update_renders_what_the_slider_callback_renders(guis):
    """Drag the JAX window's sliders (``set_val`` fires its callback) and
    hand the port's ``update`` the same values."""
    g, gui = guis
    sliders, im = g["sliders"], g["im"]
    for setting in SETTINGS:
        for k, where in zip(port_gui.CONTINUOUS, setting):
            sliders[k].set_val(_at(gui.ranges[k], where))
        values = {k: sliders[k].val for k in port_gui.CONTINUOUS}
        close(gui.update({**values, "mix": 0.0}), im.get_array())
    sliders["mix"].set_val(0.75)
    close(gui.update({**values, "mix": 0.75}), im.get_array())
    sliders["mix"].set_val(0.0)


def test_headless_grid_matches_jax_frames(guis, gui_dirs, tmp_path, capsys):
    g, gui = guis
    png = str(tmp_path / "gui.png")
    assert port_gui.main(["--headless", "--data-dir", str(gui_dirs), "--model-dir", str(gui_dirs),
                          "--image-index", str(INDEX), "--output", png, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows, titles = gui.grid()
    pix = read_png(png)
    assert pix.shape == (4 * 28, 5 * 28)
    grid = np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)
    assert np.array_equal(pix, np.clip(np.round((grid + 1) / 2 * 255), 0, 255).astype(np.uint8))
    for r, name in enumerate(port_gui.CONTINUOUS):  # the JAX script's frames at the grid's positions
        for c, v in enumerate(np.linspace(*gui.ranges[name], 5)):
            vals = dict(gui.values, **{name: float(v)})
            close(rows[r][c], g["cf_image"](**vals))
        assert titles[r][0] in out
    for c, v in enumerate(np.linspace(0.0, 1.0, 5)):
        close(rows[3][c], g["mix_image"](float(v)))
    assert f"digit {gui.digit}->8 mix=1.00" in out


def test_without_headless_it_exits_non_zero(capsys):
    assert port_gui.main(["--data-dir", "x", "--model-dir", "y"]) != 0
    assert "--headless" in capsys.readouterr().err
