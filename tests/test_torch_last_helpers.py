"""The last helpers of the port against the JAX package's, on the CPU:

- the resamplers (``resample_poly``, ``resample_kaiser_best`` and every
  ``filter`` of ``resample``, with both refusals): 1e-10 in float64 (the same
  numpy operations in the same order);
- the ESRF Griffin-Lim inverse with JAX's initial phase injected: 2e-3 of
  max |x| (the STFT tests' rule for the inverse, here after 4 iterations);
- ``Uniform`` given JAX's unit draw, and its ``log_prob`` with points outside
  the range (-inf in both): 1e-6;
- the plot helpers, rasterised here, against matplotlib's drawing of the
  JAX helpers: every outline pixel within 0.5 px (in each coordinate) of
  matplotlib's outline, every vertex of ``Ellipse.get_verts()`` /
  ``Polygon.get_xy()`` next to a drawn pixel, and the digit panels' colours
  those of ``imshow(cmap="gray_r")`` to its 256-level table (1/255).
"""
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from imagecfgen_tpu.data import esrf as jesrf  # noqa: E402
from imagecfgen_tpu.flows.distributions import Uniform as JUniform  # noqa: E402
from imagecfgen_tpu.morphomnist import util as jutil  # noqa: E402
from imagecfgen_tpu.ops import resample as jres  # noqa: E402
from imagecfgen_tpu.ops import stft as jstft  # noqa: E402
from imagecfgen_torch.data import esrf as tesrf  # noqa: E402
from imagecfgen_torch.flows.distributions import Uniform  # noqa: E402
from imagecfgen_torch.morphomnist import util  # noqa: E402
from imagecfgen_torch.morphomnist.morpho import ImageMoments, bounding_parallelogram  # noqa: E402
from imagecfgen_torch.ops import resample as tres  # noqa: E402


def _signals(n=2, length=1201, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 8000.0
    return np.sin(2 * np.pi * rng.uniform(50, 3000, (n, 1)) * t) + 0.1 * rng.normal(size=(n, length))


# ------------------------------------------------------------ resampling


@pytest.mark.parametrize("up,down", [(1, 6), (3, 2), (2, 3), (4, 4)])
def test_resample_poly_matches_jax(up, down):
    x = _signals()
    np.testing.assert_allclose(tres.resample_poly(x, up, down), jres.resample_poly(x, up, down), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(tres.resample_poly(x, up, down, beta=8.0), jres.resample_poly(x, up, down, beta=8.0),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("up,down", [(1, 6), (3, 2)])
def test_resample_kaiser_best_matches_jax(up, down):
    x = _signals(length=601, seed=1)
    got = tres.resample_kaiser_best(x, up, down)
    assert got.shape == (2, -(-601 * up // down))
    np.testing.assert_allclose(got, jres.resample_kaiser_best(x, up, down), rtol=1e-10, atol=1e-10)
    assert tres.KAISER_BEST == jres.KAISER_BEST


@pytest.mark.parametrize("filt", ["fft", "kaiser_best", "scipy_poly"])
@pytest.mark.parametrize("rates", [(48000, 8000), (8000, 12000), (8000, 8000)])
def test_resample_filters_match_jax(filt, rates):
    x = _signals(length=960, seed=2)
    np.testing.assert_allclose(tres.resample(x, *rates, filter=filt), jres.resample(x, *rates, filter=filt),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("filt,match", [("scipy", "ambiguous"), ("sinc", "unknown filter")])
def test_resample_refusals(filt, match):
    x = _signals(length=96)
    for mod in (tres, jres):
        with pytest.raises(ValueError, match=match):
            mod.resample(x, 48000, 8000, filter=filt)


# ------------------------------------------------------------ the ESRF inverse


def test_esrf_audio_from_log_spect_matches_jax():
    assert tesrf.ESRF_GL_STFT == tesrf.ESRF_GL_STFT.__class__(**{
        k: getattr(jesrf.ESRF_GL_STFT, k) for k in ("n_fft", "win_length", "hop_length", "pad")})
    x = _signals(1, 8000, seed=3).astype(np.float32)
    power = np.asarray(jstft.spectrogram(jnp.asarray(x), jesrf.ESRF_GL_STFT))
    log_spec = np.log(power + 1e-6).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jesrf.esrf_audio_from_log_spect(jnp.asarray(log_spec), rng=key, n_iter=4))
    angle = np.array(jax.random.uniform(key, log_spec.shape, minval=-np.pi, maxval=np.pi))
    got = tesrf.esrf_audio_from_log_spect(torch.from_numpy(log_spec), n_iter=4, angle=torch.from_numpy(angle))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())


# ------------------------------------------------------------ Uniform


@pytest.mark.parametrize("low,high,event", [(0.0, 1.0, (1,)), (-2.5, 4.0, (3,))])
def test_uniform_matches_jax(low, high, event):
    key = jax.random.PRNGKey(7)
    n = 256
    want = np.asarray(JUniform(low, high, event).sample(key, n))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n, *event))))
    dist = Uniform(low, high, event)
    got = dist.sample(None, n, u=u)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    drawn = dist.sample(torch.Generator().manual_seed(0), n)
    assert drawn.shape == (n, *event) and bool(((drawn >= low) & (drawn <= high)).all())

    x = np.concatenate([want, want[:8] + (high - low) * 1.5, want[:8] - (high - low)]).astype(np.float32)
    x[0, 0] = low  # the range is closed
    lp_j = np.asarray(JUniform(low, high, event).log_prob(jnp.asarray(x)))
    lp_t = dist.log_prob(torch.from_numpy(x)).numpy()
    assert np.isneginf(lp_t[n:]).all() and np.array_equal(np.isneginf(lp_t), np.isneginf(lp_j))
    np.testing.assert_allclose(lp_t[:n], lp_j[:n], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the plot helpers


def _digit():
    yy, xx = np.mgrid[:28, :28]
    u, v = (xx - 13.3) * np.cos(0.5) + (yy - 14.1) * np.sin(0.5), -(xx - 13.3) * np.sin(0.5) + (yy - 14.1) * np.cos(0.5)
    return 255.0 * np.exp(-(u / 6.0) ** 2 - (v / 2.5) ** 2)


def _drawn(canvas):
    r, c = np.nonzero(canvas.any(axis=2))
    return np.stack([c, r], axis=1).astype(np.float64)  # pixel centres as (x, y)


def _max_norm_to_curve(points, curve):
    return np.abs(points[:, None, :] - curve[None]).max(axis=2).min(axis=1)


def _bezier_outline(patch, per_curve=400):
    """Matplotlib's outline, its path's Bezier curves evaluated densely."""
    t = np.linspace(0, 1, per_curve)
    pts = [bez.point_at_t(t) for bez, _ in patch.get_path().iter_bezier()]
    return patch.get_patch_transform().transform(np.concatenate(pts))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_plot_ellipse_matches_matplotlib(scale):
    m = ImageMoments(_digit())
    fig, ax = plt.subplots()
    ell = jutil.plot_ellipse(m, ax, scale=scale)
    canvas = util.plot_ellipse(m, np.zeros((28, 28, 3)), scale=scale)
    drawn = _drawn(canvas)
    assert len(drawn) > 20
    assert _max_norm_to_curve(drawn, _bezier_outline(ell)).max() <= 0.5 + 1e-2
    verts = ell.get_patch_transform().transform(ell.get_path().vertices[::3])  # the curves' end points
    inside = (verts >= -0.5).all(axis=1) & (verts < 27.5).all(axis=1)
    assert np.abs(verts[inside][:, None] - drawn[None]).max(axis=2).min(axis=1).max() <= 1.0
    assert len(ell.get_verts()) > 0
    plt.close(fig)


def test_plot_parallelogram_matches_matplotlib():
    img = _digit()
    corners = bounding_parallelogram(img, 0.02, ImageMoments(img))
    fig, ax = plt.subplots()
    poly = jutil.plot_parallelogram(corners, ax)
    xy = poly.get_xy()  # closed: the first corner again at the end
    canvas = util.plot_parallelogram(corners, np.zeros((28, 28, 3)))
    drawn = _drawn(canvas)
    dense = np.concatenate([a + np.linspace(0, 1, 500)[:, None] * (b - a) for a, b in zip(xy[:-1], xy[1:])])
    assert _max_norm_to_curve(drawn, dense).max() <= 0.5 + 1e-9
    inside = (xy >= -0.5).all(axis=1) & (xy < 27.5).all(axis=1)
    assert np.abs(xy[inside][:, None] - drawn[None]).max(axis=2).min(axis=1).max() <= 0.5
    plt.close(fig)


def _imshow_rgb(ax):
    im = ax.images[0]
    return im.cmap(im.norm(im.get_array()))[..., :3]


def test_plot_digit_and_grid_colours_match_imshow():
    rng = np.random.default_rng(5)
    img = _digit()
    ax = jutil.plot_digit(img)
    np.testing.assert_allclose(util.plot_digit(img), _imshow_rgb(ax), rtol=0, atol=1 / 255 + 1e-9)
    assert util.plot_digit(img, scale=3).shape == (84, 84, 3)
    images = rng.uniform(0, 255, (13, 28, 28))
    fig, axes = jutil.plot_grid(images, n_cols=5)
    grid = util.plot_grid(images, n_cols=5)
    assert grid.shape == (3 * 28, 5 * 28, 3)
    for i in range(13):
        r, c = divmod(i, 5)
        np.testing.assert_allclose(grid[r * 28:(r + 1) * 28, c * 28:(c + 1) * 28], _imshow_rgb(axes[r, c]),
                                   rtol=0, atol=1 / 255 + 1e-9)
    assert (grid[2 * 28:, 3 * 28:] == 1.0).all()  # the unused cells
    plt.close("all")
