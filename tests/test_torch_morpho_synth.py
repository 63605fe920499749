"""The port's Morpho-MNIST synthesis and measured-counterfactual helpers
against the JAX package's, on seeded ``synthetic_digits`` glyphs:

- ``GroundTruthSCM``'s draws, ``perturb_image`` and ``synthesize_dataset``
  (8 glyphs at scale 4, 2 at scale 16, and through a spawned pool) are
  equal to the JAX functions' (``assert_array_equal``);
- ``metrics/measured.py`` agrees with the JAX module to 1e-9 (the C++
  engine sums the thickness in another order than numpy's mean);
- the dataset CLIs (``create_train_dataset``, ``create_test_dataset``,
  through their ``main``) write the JAX scripts' arrays, with
  ``--noise-std`` (the hard battery mode) and ``--csv``; their parsers take
  the JAX scripts' flags and, touching no tensor, no ``--device``.
"""
import contextlib
import importlib
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from imagecfgen_tpu.data import morphomnist_synth as j_synth
from imagecfgen_tpu.metrics import measured as j_measured
from imagecfgen_torch.data import morphomnist_synth as t_synth
from imagecfgen_torch.data.synthetic_digits import synthetic_digits
from imagecfgen_torch.metrics import measured as t_measured

REPO = Path(__file__).resolve().parents[1]
DATASET_CLIS = ("create_train_dataset", "create_test_dataset")


def test_ground_truth_scm_draws_equal_jax():
    j = j_synth.GroundTruthSCM(np.random.default_rng(3))
    t = t_synth.GroundTruthSCM(np.random.default_rng(3))
    for want, got in zip(j.sample(64), t.sample(64)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    noise = np.random.default_rng(4).normal(0, 1, (5, 1))
    np.testing.assert_array_equal(t.sample_thickness(5, noise), j.sample_thickness(5, noise))
    np.testing.assert_array_equal(t.sample_slant(5, noise), j.sample_slant(5, noise))
    np.testing.assert_array_equal(t.sample_intensity(noise, noise), j.sample_intensity(noise, noise))


@pytest.mark.parametrize("engine", ["native", "python"])
def test_perturb_image_equals_jax(engine):
    imgs, _ = synthetic_digits(3, seed=5)
    for k, (t, i, s) in enumerate(((1.0, 80.0, -0.3), (4.5, 220.0, 0.2), (2.5, 150.0, 0.0))):
        want = j_synth.perturb_image(imgs[k] / 255.0, t, i, s, scale=4)
        got = t_synth.perturb_image(imgs[k] / 255.0, t, i, s, scale=4, engine=engine)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,scale", [(8, 4), (2, 16)])
def test_synthesize_dataset_equals_jax(n, scale):
    imgs, labels = synthetic_digits(n, seed=4)
    want_x, want_a = j_synth.synthesize_dataset(imgs, labels, seed=4, scale=scale)
    x, a = t_synth.synthesize_dataset(imgs, labels, seed=4, scale=scale)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(a, want_a)
    # the regression of tests/test_morphomnist.py: no blank glyph
    assert (x.max(axis=(1, 2)) > 50.0).all()


def test_a_spawned_pool_gives_the_same_glyphs():
    imgs, labels = synthetic_digits(6, seed=8)
    attrs = {"thickness": np.linspace(1, 5, 6), "intensity": np.linspace(70, 250, 6),
             "slant": np.linspace(-0.5, 0.5, 6)}
    want_x, want_a = j_synth.synthesize_dataset(imgs / 255.0, labels, scale=4, attrs=attrs)
    x, a = t_synth.synthesize_dataset(imgs / 255.0, labels, scale=4, attrs=attrs, workers=2)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(a, want_a)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_measured_attributes_match_jax(engine):
    imgs, labels = synthetic_digits(6, seed=9)
    x, a = t_synth.synthesize_dataset(imgs / 255.0, labels, seed=9, scale=4)
    want = j_measured.measure_attributes(x)
    got = t_measured.measure_attributes(x, engine=engine)
    assert got.shape == (6, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t_measured.measure_attributes_single(x[0], engine=engine),
                               j_measured.measure_attributes_single(x[0]), rtol=0, atol=1e-9)
    # the intensity column is what synthesis imposed, the median bright pixel
    np.testing.assert_allclose(got[:, 1], a[:, 11], rtol=1e-4)

    model_out = (x[..., None] / 255.0 * 2.0 - 1.0).astype(np.float32)
    np.testing.assert_array_equal(t_measured.images_to_255(model_out), j_measured.images_to_255(model_out))
    targets = {"thickness": a[:, 10:11], "slant": a[:, 12]}
    assert t_measured.median_abs_errors(targets, got) == j_measured.median_abs_errors(targets, got)
    assert t_measured.measure_attributes(np.zeros((0, 28, 28))).shape == (0, 3)


# ------------------------------------------------------------ the CLIs


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", DATASET_CLIS)
def test_dataset_parsers_take_the_jax_scripts_flags(name):
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x")["parser"]
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    assert _options(tparser) == _options(jparser)
    port = {a.dest: a for a in tparser._actions}
    for a in jparser._actions:
        t = port[a.dest]
        assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
            a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest


def run_port(name, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert importlib.import_module(f"imagecfgen_torch.cli.{name}").main([*map(str, argv)]) == 0
    return out.getvalue()


def run_jax(name, *argv):
    old = sys.argv
    sys.argv = [name, *map(str, argv)]
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            runpy.run_path(str(REPO / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old


def load(d, split):
    return np.load(d / f"mnist-x-{split}.npy"), np.load(d / f"mnist-a-{split}.npy")


SMALL = ("--synthetic", 16, "--scale", 4, "--workers", 1)


@pytest.mark.parametrize("split", ["train", "test"])
def test_create_train_dataset_writes_the_jax_scripts_arrays(tmp_path, split):
    for name, run in (("port", run_port), ("jax", run_jax)):
        run("create_train_dataset", *SMALL, "--split", split, "--seed", 3, "--out-dir", tmp_path / name)
    x, a = load(tmp_path / "port", split)
    want_x, want_a = load(tmp_path / "jax", split)
    assert x.shape == (16, 28, 28) and a.shape == (16, 13) and x.dtype == a.dtype == np.float32
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(a, want_a)


def test_noise_std_is_the_hard_battery_mode(tmp_path):
    """``--noise-std`` adds the JAX scripts' noise (seeds +7919 and +7920):
    the same pixels as the JAX scripts, the attributes unchanged."""
    for name, noise in (("clean", 0), ("noisy", 8)):
        run_port("create_train_dataset", *SMALL, "--limit", 8, "--noise-std", noise,
                 "--out-dir", tmp_path / name)
        run_port("create_test_dataset", *SMALL, "--limit", 8, "--noise-std", noise,
                 "--out-dir", tmp_path / name)
    run_jax("create_train_dataset", *SMALL, "--limit", 8, "--noise-std", 8, "--out-dir", tmp_path / "jax")
    run_jax("create_test_dataset", *SMALL, "--limit", 8, "--noise-std", 8, "--out-dir", tmp_path / "jax")
    for split in ("train", "test"):
        clean, noisy, jax_ = (load(tmp_path / d, split) for d in ("clean", "noisy", "jax"))
        np.testing.assert_array_equal(noisy[0], jax_[0])
        np.testing.assert_array_equal(noisy[1], clean[1])
        assert not np.array_equal(noisy[0], clean[0])
        assert noisy[0].min() >= 0 and noisy[0].max() <= 255


def test_create_test_dataset_reads_a_deepscm_csv(tmp_path):
    csv = tmp_path / "deepscm.csv"
    rows = ["index,thickness,intensity,extra"]
    rows += [f"{k},{1.0 + 0.3 * k},{90.0 + 11 * k},x" for k in range(12)]
    csv.write_text("\n".join(rows) + "\n")
    run_port("create_test_dataset", *SMALL, "--limit", 6, "--csv", csv, "--out-dir", tmp_path / "port")
    run_jax("create_test_dataset", *SMALL, "--limit", 6, "--csv", csv, "--out-dir", tmp_path / "jax")
    x, a = load(tmp_path / "port", "test")
    want_x, want_a = load(tmp_path / "jax", "test")
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_allclose(a[:, 10], 1.0 + 0.3 * np.arange(6), rtol=1e-6)
    bad = tmp_path / "bad.csv"
    bad.write_text("thickness\n1.0\n")
    with pytest.raises(ValueError, match="intensity"):
        run_port("create_test_dataset", *SMALL, "--limit", 2, "--csv", bad, "--out-dir", tmp_path / "bad")
