"""The port's Morpho-MNIST oracle (``imagecfgen_torch/morphomnist``) against
the JAX package's (``imagecfgen_tpu/morphomnist``) on the same inputs:
seeded ``synthetic_digits`` glyphs and numpy-drawn binary images.

- skeletons, distance maps, hi-res and binary images, and every
  perturbation's output are equal (``assert_array_equal``), for each of the
  port's two engines (``"native"``: ``csrc/morphometry.cpp``; ``"python"``:
  scipy's EDT, numpy's order and the loop of ``csrc/skeletonize.cpp``);
- metrics agree to atol 1e-9 across engines and packages, the JAX package's
  own tolerance (``tests/test_native_engine.py``): the C++ sums the
  thickness in another order than numpy's mean;
- the hand-derived goldens of ``tests/test_morpho_golden.py`` hold for the
  port, engine by engine;
- a host-compiler build that fails raises; nothing falls back.
"""
import numpy as np
import pytest

from imagecfgen_tpu.morphomnist import _skeletonize as j_sk
from imagecfgen_tpu.morphomnist import engine as j_engine
from imagecfgen_tpu.morphomnist import measure as j_measure
from imagecfgen_tpu.morphomnist import morpho as j_morpho
from imagecfgen_tpu.morphomnist import perturb as j_perturb
from imagecfgen_tpu.morphomnist import skeleton as j_skeleton
from imagecfgen_torch.data.synthetic_digits import synthetic_digits
from imagecfgen_torch.morphomnist import _skeletonize as t_sk
from imagecfgen_torch.morphomnist import engine as t_engine
from imagecfgen_torch.morphomnist import measure as t_measure
from imagecfgen_torch.morphomnist import morpho as t_morpho
from imagecfgen_torch.morphomnist import perturb as t_perturb
from imagecfgen_torch.morphomnist import skeleton as t_skeleton

ENGINES = ("native", "python")
METRIC_ATOL = 1e-9


def glyphs(n, seed):
    return synthetic_digits(n, seed=seed)[0]


def hires_binary(img, scale=4):
    hi = np.clip(j_morpho.pyramid_expand(img / img.max(), scale), 0, 1)
    return hi >= 0.5


def random_binary(seed, shape=(40, 52), p=0.45):
    return np.random.default_rng(seed).random(shape) > p


# ------------------------------------------------------------ skeletons


def test_removal_table_and_tiebreak_are_the_jax_packages():
    np.testing.assert_array_equal(t_sk._removal_table(), j_sk._removal_table())
    x = np.arange(0, 10_000, 7, dtype=np.uint64)
    np.testing.assert_array_equal(t_sk._splitmix64(x), j_sk._splitmix64(x))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("source", ["glyph", "random"])
def test_medial_axis_equals_jax(engine, source):
    binaries = ([hires_binary(img) for img in glyphs(3, 11)] if source == "glyph"
                else [random_binary(s) for s in range(3)])
    for binary in binaries:
        want_skel, want_dist = j_sk.medial_axis(binary, return_distance=True)
        skel, dist = t_sk.medial_axis(binary, return_distance=True, engine=engine)
        np.testing.assert_array_equal(skel, want_skel)
        np.testing.assert_array_equal(dist, want_dist)
        np.testing.assert_array_equal(t_sk.medial_axis(binary, engine=engine), want_skel)


def test_cpp_thinning_loop_equals_its_python_spec():
    from scipy import ndimage as ndi

    for binary in (random_binary(5), hires_binary(glyphs(1, 3)[0])):
        ii, jj, order = t_sk.thinning_order(binary, ndi.distance_transform_edt(binary))
        a, b = (np.ascontiguousarray(binary.astype(np.uint8)) for _ in range(2))
        t_sk._loop_native(a, ii, jj, order, t_sk._removal_table())
        t_sk._loop_python(b, ii, jj, order, t_sk._removal_table())
        np.testing.assert_array_equal(a, b)
        assert a.sum() < binary.sum()


def test_native_edt_and_metrics():
    from scipy import ndimage as ndi

    binary = random_binary(0, (64, 80), 0.4)
    dist, skel, metrics = t_engine.morphometry_batch(binary[None], want_distance=True,
                                                     want_skeleton=True)
    np.testing.assert_array_equal(dist[0], ndi.distance_transform_edt(binary))
    _, j_skel, j_metrics = j_engine.morphometry_batch(binary[None], want_distance=True,
                                                      want_skeleton=True)
    np.testing.assert_array_equal(skel, j_skel)
    np.testing.assert_array_equal(metrics, j_metrics)
    assert metrics[0, 0] == binary.sum() and metrics[0, 3] == skel[0].sum()


def test_unknown_engine_is_refused():
    with pytest.raises(ValueError, match="unknown engine"):
        t_sk.medial_axis(random_binary(0), engine="auto")
    with pytest.raises(ValueError, match="unknown engine"):
        t_measure.measure_batch(glyphs(1, 0), engine="auto")


def test_a_failing_host_build_raises(monkeypatch, tmp_path):
    """With a compiler that fails and no build at hand, both engines raise;
    neither takes the other's route."""
    from imagecfgen_torch.ops import _build

    def fresh():
        t_engine._native_lib.cache_clear()
        for key in [k for k in _build._LIBS if k.startswith("host:")]:
            del _build._LIBS[key]

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    fresh()
    try:
        binary = hires_binary(glyphs(1, 2)[0])
        for engine in ENGINES:
            with pytest.raises(RuntimeError, match="failed for"):
                t_sk.medial_axis(binary, engine=engine)
        with pytest.raises(RuntimeError, match="failed for morphometry.cpp"):
            t_measure.measure_batch(glyphs(2, 2))
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="could not be run"):
            t_measure.measure_batch(glyphs(2, 2))
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        monkeypatch.undo()
        fresh()


# ------------------------------------------------ morphology and moments


@pytest.mark.parametrize("shape,factor", [((28, 28), 4), ((65, 65), 16), ((30, 17), 3)])
def test_pyramids_equal_jax(shape, factor):
    img = np.random.default_rng(0).random(shape)
    np.testing.assert_array_equal(t_morpho.pyramid_expand(img, factor), j_morpho.pyramid_expand(img, factor))
    np.testing.assert_array_equal(t_morpho.pyramid_reduce(img, factor), j_morpho.pyramid_reduce(img, factor))
    assert t_morpho.pyramid_reduce(img, factor).shape == tuple(-(-s // factor) for s in shape)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scale", [1, 4])
def test_image_morphology_equals_jax(engine, scale):
    for img in glyphs(3, 21):
        want = j_morpho.ImageMorphology(img, scale=scale)
        got = t_morpho.ImageMorphology(img, scale=scale, engine=engine)
        for name in ("hires_image", "binary_image", "skeleton", "distance_map"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        for name in ("area", "stroke_length", "mean_thickness", "median_thickness"):
            assert getattr(got, name) == pytest.approx(getattr(want, name), abs=METRIC_ATOL), name
        np.testing.assert_array_equal(got.downscale(got.binary_image), want.downscale(want.binary_image))


def test_moments_and_parallelogram_equal_jax():
    for img in glyphs(3, 13):
        hi = np.clip(t_morpho.pyramid_expand(img / img.max(), 4), 0, 1)
        jm, tm = j_morpho.ImageMoments(hi), t_morpho.ImageMoments(hi)
        for name in ("centroid", "covariance", "axis_lengths", "angle", "horizontal_shear",
                     "vertical_shear", "m00"):
            assert getattr(tm, name) == getattr(jm, name), name
        np.testing.assert_array_equal(np.array(t_morpho.bounding_parallelogram(hi, 0.02, tm)),
                                      np.array(j_morpho.bounding_parallelogram(hi, 0.02, jm)))


def test_skeleton_utilities_equal_jax():
    morph = t_morpho.ImageMorphology(glyphs(1, 4)[0], scale=4)
    skel = morph.skeleton
    for r in (0, 2, 5):
        np.testing.assert_array_equal(t_skeleton.disk(r), j_skeleton.disk(r))
    np.testing.assert_array_equal(t_skeleton.num_neighbours(skel), j_skeleton.num_neighbours(skel))
    tips = t_skeleton.num_neighbours(skel) == 1
    np.testing.assert_array_equal(t_skeleton.erase(skel, tips, 3), j_skeleton.erase(skel, tips, 3))
    i, j = np.argwhere(skel)[len(np.argwhere(skel)) // 2]
    assert t_skeleton.get_angle(skel, i, j, 8) == j_skeleton.get_angle(skel, i, j, 8)

    jmorph = j_morpho.ImageMorphology(glyphs(1, 4)[0], scale=4)
    for sampler in ((None, None), (1.0, 1.0)):
        np.random.seed(7)
        want = j_skeleton.LocationSampler(*sampler).sample(jmorph, 5)
        np.random.seed(7)
        got = t_skeleton.LocationSampler(*sampler).sample(morph, 5)
        np.testing.assert_array_equal(got, want)
        # an explicit RandomState seeded alike draws the same locations
        got = t_skeleton.LocationSampler(*sampler).sample(morph, 5, np.random.RandomState(7))
        np.testing.assert_array_equal(got, want)


PERTURBATIONS = {
    "Thinning": lambda m: m.Thinning(0.7),
    "Thickening": lambda m: m.Thickening(1.0),
    "Swelling": lambda m: m.Swelling(3, 7),
    "Fracture": lambda m: m.Fracture(),
    "SetThickness_up": lambda m: m.SetThickness(5.0),
    "SetThickness_down": lambda m: m.SetThickness(1.0),
    "SetIntensity": lambda m: m.SetIntensity(150.0),
    "SetSlant": lambda m: m.SetSlant(0.4),
    "SetWidth": lambda m: m.SetWidth(12.0, validate=True),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(PERTURBATIONS))
def test_perturbation_equals_jax(name, engine):
    """Every perturbation's hi-res output on the same glyphs is the JAX
    package's, bit for bit (Swelling and Fracture after the same
    ``np.random.seed``)."""
    for k, img in enumerate(glyphs(2, 31)):
        np.random.seed(100 + k)
        want = PERTURBATIONS[name](j_perturb)(j_morpho.ImageMorphology(img, scale=4))
        np.random.seed(100 + k)
        got = PERTURBATIONS[name](t_perturb)(t_morpho.ImageMorphology(img, scale=4, engine=engine))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_disk_morphology_equals_jax():
    img = np.random.default_rng(0).uniform(size=(64, 64)) > 0.85
    for r in (0, 1, 3, 7):
        np.testing.assert_array_equal(t_perturb.disk_dilation(img, r), j_perturb.disk_dilation(img, r))
        np.testing.assert_array_equal(t_perturb.disk_erosion(img, r), j_perturb.disk_erosion(img, r))
        np.testing.assert_array_equal(t_perturb._soft_disk(r), j_perturb._soft_disk(r))


# ------------------------------------------------------------ measurement


@pytest.mark.parametrize("engine", ENGINES)
def test_measure_image_matches_jax(engine):
    for img in glyphs(3, 12):
        want = j_measure.measure_image(img, verbose=False)
        got = t_measure.measure_image(img, verbose=False, engine=engine)
        assert got._fields == want._fields
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=METRIC_ATOL)


def test_measure_batch_engines_agree_with_each_other_and_jax():
    imgs = glyphs(8, 12)
    native = t_measure.measure_batch(imgs)
    python = t_measure.measure_batch(imgs, engine="python")
    assert list(native) == list(python) == ["area", "length", "thickness", "slant", "width", "height"]
    assert all(v.dtype == np.float64 and v.shape == (8,) for v in native.values())
    want = j_measure.measure_batch(imgs, engine="python").to_numpy()
    for table in (native, python):
        np.testing.assert_allclose(t_measure.as_array(table), want, rtol=0, atol=METRIC_ATOL)
    threaded = t_measure.measure_batch(imgs, workers=3)
    np.testing.assert_array_equal(t_measure.as_array(threaded), t_measure.as_array(native))


# ------------------------------------------------ the hand-derived goldens


def _strip(h0=10, h1=15):
    img = np.zeros((28, 28), np.float32)
    img[h0:h1, :] = 1.0
    return img


def golden_strip(engine):
    """Rows 10..14 of a 28x28 canvas: the ridge is row 12 at EDT 3, so
    thickness 6; 28 skeleton pixels, 27 unit segments; area 140."""
    m = t_morpho.ImageMorphology(_strip(), scale=1, engine=engine)
    ys, xs = np.nonzero(m.skeleton)
    assert set(ys) == {12} and len(xs) == 28
    assert m.mean_thickness == pytest.approx(6.0) and m.median_thickness == pytest.approx(6.0)
    assert m.area == pytest.approx(140.0) and m.stroke_length == pytest.approx(27.0)


def golden_square(engine):
    """A filled 15x15 square: its medial axis is the two diagonals (29
    pixels), the median EDT 4 (thickness 8)."""
    img = np.zeros((28, 28), np.float32)
    img[6:21, 6:21] = 1.0
    m = t_morpho.ImageMorphology(img, scale=1, engine=engine)
    ys, xs = np.nonzero(m.skeleton)
    assert len(ys) == 29
    assert np.all(((ys - 6) == (xs - 6)) | ((ys - 6) == (20 - xs)))
    assert m.median_thickness == pytest.approx(8.0) and m.area == pytest.approx(225.0)


def golden_line(engine):
    """A one-pixel line is its own skeleton, EDT 1 everywhere: thickness 2,
    length 19."""
    img = np.zeros((28, 28), np.float32)
    img[14, 4:24] = 1.0
    m = t_morpho.ImageMorphology(img, scale=1, engine=engine)
    assert np.array_equal(np.nonzero(m.skeleton), np.nonzero(img > 0))
    assert m.mean_thickness == pytest.approx(2.0) and m.stroke_length == pytest.approx(19.0)


def golden_upscaled_strip(engine):
    """The strip at scale 4 reports the same thickness in original units."""
    m = t_morpho.ImageMorphology(_strip(), scale=4, engine=engine)
    assert m.mean_thickness == pytest.approx(5.0, abs=0.6)
    assert m.area == pytest.approx(140.0, rel=0.05)


def golden_thickening(engine):
    """Thickening(1.0) dilates by int(6/2) = 3: height 11, thickness 12."""
    out = t_perturb.Thickening(amount=1.0)(t_morpho.ImageMorphology(_strip(), scale=1, engine=engine))
    assert t_morpho.ImageMorphology(out.astype(np.float32), scale=1, engine=engine).mean_thickness \
        == pytest.approx(12.0)


def golden_set_thickness(engine):
    """SetThickness(10) on thickness 6: radius 2, height 9, thickness 10."""
    out = t_perturb.SetThickness(10.0)(t_morpho.ImageMorphology(_strip(), scale=1, engine=engine))
    assert t_morpho.ImageMorphology(out.astype(np.float32), scale=1, engine=engine).mean_thickness \
        == pytest.approx(10.0)


def golden_thinning(engine):
    """Thinning(0.7): radius int(0.7*6/2) = 2 leaves row 12, thickness <= 4."""
    out = t_perturb.Thinning(amount=0.7)(t_morpho.ImageMorphology(_strip(), scale=1, engine=engine))
    m2 = t_morpho.ImageMorphology(out.astype(np.float32), scale=1, engine=engine)
    assert set(np.nonzero(m2.skeleton)[0]) == {12} and m2.mean_thickness <= 4.0


GOLDENS = {f.__name__: f for f in (golden_strip, golden_square, golden_line, golden_upscaled_strip,
                                    golden_thickening, golden_set_thickness, golden_thinning)}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_hand_derived_goldens_hold_for_the_port(golden, engine):
    GOLDENS[golden](engine)
