"""The port's marine data paths (``imagecfgen_torch/data/whalecalls.py``,
``data/esrf.py``) against the JAX package's, on the CPU.

- the synthetic stand-ins: every window, label, distance and start bit for
  bit (both packages draw them with numpy from the same seed);
- the spectrograms (256 x 256 and 512 x 512, computed on the stream's
  device): the power ``exp(log_spectrogram) - 1e-6`` to 4e-6 of its max (an
  FFT of 511 or 1023 terms rounded in another order, squared: the AudioMNIST
  tolerance of ``tests/test_torch_audio_data.py``), and the images after the
  same statistics to 5e-4 (the log of a power near 0 amplifies its rounding);
- the real-data paths on the XBAT-style call logs and the station CSV that
  ``tests/test_real_data_fixtures.py`` writes: the parsed events, the split's
  membership, the windows in their shuffled order, the SNR filter, the
  moving-average filter, the station's ``closest_boat`` and the membership
  of its split, bit for bit; the port reads the CSV without pandas.
"""
import numpy as np
import pytest
import torch
from test_real_data_fixtures import esrf_station, whale_dirs  # noqa: F401  (fixtures)

from imagecfgen_tpu.data import esrf as jesrf
from imagecfgen_tpu.data import whalecalls as jwhale
from imagecfgen_tpu.ops.spectral import SpectStats as JStats
from imagecfgen_torch.data import esrf as tesrf
from imagecfgen_torch.data import whalecalls as twhale
from imagecfgen_torch.ops.spectral import SpectStats

POWER_TOL, IMAGE_TOL = 4e-6, 5e-4


def assert_spectrograms_close(want: np.ndarray, got: torch.Tensor):
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    got = got.numpy()
    pw, pg = np.exp(want.astype(np.float64)) - 1e-6, np.exp(got.astype(np.float64)) - 1e-6
    np.testing.assert_allclose(pg, pw, rtol=0, atol=POWER_TOL * pw.max())
    stats = JStats.compute(want)
    jimg = np.asarray(stats.spect_to_img(want))
    timg = SpectStats(torch.from_numpy(np.array(stats.mean)), torch.from_numpy(np.array(stats.std))
                      ).spect_to_img(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=IMAGE_TOL)


def test_stft_configs_are_the_jax_packages():
    for t, j in ((twhale.WHALE_STFT, jwhale.WHALE_STFT), (twhale.WHALE_GL_STFT, jwhale.WHALE_GL_STFT),
                 (tesrf.ESRF_STFT, jesrf.ESRF_STFT)):
        for field in ("n_fft", "win_length", "hop", "pad", "power", "center"):
            assert getattr(t, field) == getattr(j, field), field
    assert twhale.WHALE_STFT.n_frames(twhale.N_SAMPLES) == twhale.WHALE_STFT.n_freqs == 256
    assert tesrf.ESRF_STFT.n_frames(tesrf.N_SAMPLES) == tesrf.ESRF_STFT.n_freqs == 512
    assert (twhale.N_SAMPLES, tesrf.N_SAMPLES) == (jwhale.N_SAMPLES, jesrf.N_SAMPLES) == (6000, 40000)


@pytest.mark.parametrize("mode,shuffle", [("train", True), ("validation", False)])
def test_whale_stand_in_streams_as_jax(mode, shuffle):
    jd, td = jwhale.WhaleCallData(synthetic_clips_per_class=4), twhale.WhaleCallData(synthetic_clips_per_class=4)
    kw = dict(batch_size=5, mode=mode, shuffle=shuffle, seed=3)
    raw = list(zip(jd.stream(transform=False, **kw), td.stream(transform=False, **kw)))
    assert len(raw) == (2 if mode == "train" else 1)
    for want, got in raw:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for want, got in zip(jd.stream(**kw), td.stream(device="cpu", **kw)):
        np.testing.assert_array_equal(got["call_type"], want["call_type"])
        assert_spectrograms_close(want["audio"], got["audio"])


@pytest.mark.parametrize("mode", ["train", "validation"])
def test_esrf_stand_in_streams_as_jax(mode):
    jd, td = jesrf.EsrfStation(synthetic_recordings=4), tesrf.EsrfStation(synthetic_recordings=4)
    kw = dict(batch_size=8, mode=mode, seed=1)
    raw = list(zip(jd.stream(transform=False, **kw), td.stream(transform=False, **kw)))
    assert raw
    if mode == "train":  # a boat recording's 10 windows
        assert sum(len(w["audio"]) for w, _ in raw) > len(raw)
    for want, got in raw:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for want, got in zip(jd.stream(**kw), td.stream(device="cpu", **kw)):
        for k in ("has_boat", "closest_boat", "start_idx"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert set(np.round(got["closest_boat"] * 50 + 50).tolist()) <= set(range(0, 31))
        assert_spectrograms_close(want["audio"], got["audio"])


def test_spectrograms_stay_on_the_streams_device(monkeypatch):
    td = twhale.WhaleCallData(synthetic_clips_per_class=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(td.stream())
    assert isinstance(next(td.stream(transform=False))["audio"], np.ndarray)


def test_griffin_lim_inverse_matches_jax():
    """The whale inverse with JAX's initial phase injected: 5e-4 of max |x|
    after 4 iterations (the AudioMNIST inverse's tolerance after 32)."""
    import jax

    td = twhale.WhaleCallData(synthetic_clips_per_class=1)
    log_spec = next(td.stream(batch_size=1, device="cpu"))["audio"]
    key = jax.random.PRNGKey(4)
    want = np.asarray(jwhale.whale_audio_from_log_spect(log_spec.numpy(), rng=key, n_iter=4))
    angle = np.array(jax.random.uniform(key, log_spec.shape, minval=-np.pi, maxval=np.pi))
    got = twhale.whale_audio_from_log_spect(log_spec, n_iter=4, angle=torch.from_numpy(angle)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * np.abs(want).max())


# ------------------------------------------------------------ the real paths


@pytest.mark.parametrize("kw", [dict(validation_split=0.0, min_upcall_snr=-10.0),
                                dict(validation_split=0.0, min_upcall_snr=10.0),
                                dict(validation_split=0.0, min_upcall_snr=-10.0, filter_length=5),
                                dict(validation_split=0.5, min_upcall_snr=-10.0, seed=7)])
def test_whale_real_path_matches_jax(whale_dirs, kw):  # noqa: F811
    nocall, shotgun, upcall = whale_dirs
    jd = jwhale.WhaleCallData(nocall, shotgun, upcall, **kw)
    td = twhale.WhaleCallData(nocall, shotgun, upcall, **kw)
    assert jd.paths == td.paths
    for kind in ("shotgun", "upcall"):
        assert set(jd.call_times[kind]) == set(td.call_times[kind])
        for date, times in jd.call_times[kind].items():
            np.testing.assert_array_equal(td.call_times[kind][date], times)
    for mode in ("train", "validation"):
        want = list(jd.stream(mode=mode, transform=False, batch_size=4))
        got = list(td.stream(mode=mode, transform=False, batch_size=4))
        assert len(got) == len(want)
        for w, g in zip(want, got):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    kinds = np.concatenate([b["call_type"].argmax(1) for b in td.stream(transform=False, batch_size=64)]
                           or [np.zeros(0, int)])
    if kw.get("validation_split") == 0.0:
        assert (kinds == 2).sum() == (0 if kw["min_upcall_snr"] > 0 else 2)  # the SNR filter


def test_whale_real_spectrograms(whale_dirs):  # noqa: F811
    nocall, shotgun, upcall = whale_dirs
    kw = dict(validation_split=0.0, min_upcall_snr=-10.0)
    jd, td = jwhale.WhaleCallData(nocall, shotgun, upcall, **kw), twhale.WhaleCallData(nocall, shotgun, upcall, **kw)
    want = next(jd.stream(batch_size=64, shuffle=False))
    got = next(td.stream(batch_size=64, shuffle=False, device="cpu"))
    assert tuple(got["audio"].shape) == (13, 256, 256)
    assert_spectrograms_close(want["audio"], got["audio"])


@pytest.mark.parametrize("seed,split", [(42, 0.2), (3, 0.5)])
def test_esrf_real_path_matches_jax(esrf_station, seed, split):  # noqa: F811
    wav_dir, labels = esrf_station
    jd = jesrf.EsrfStation(wav_dir, labels, validation_split=split, seed=seed)
    td = tesrf.EsrfStation(wav_dir, labels, validation_split=split, seed=seed)
    assert (td.train_paths, td.validation_paths) == (jd.train_paths, jd.validation_paths)
    np.testing.assert_array_equal(td.filepaths, np.asarray(jd.df["filepath"]))
    np.testing.assert_array_equal(td.distance_feature, jd.distance_feature)
    np.testing.assert_array_equal(td.has_boat_flag, jd.has_boat_flag)
    assert "rec_8000_far.wav" not in td.filepaths  # distance 50 > 30
    for mode in ("train", "validation"):
        want = list(jd.stream(mode=mode, transform=False, batch_size=4, seed=2))
        got = list(td.stream(mode=mode, transform=False, batch_size=4, seed=2))
        assert len(got) == len(want)
        for w, g in zip(want, got):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_esrf_real_spectrograms_and_scaled_distance(esrf_station):  # noqa: F811
    wav_dir, labels = esrf_station
    jd = jesrf.EsrfStation(wav_dir, labels, validation_split=0.0)
    td = tesrf.EsrfStation(wav_dir, labels, validation_split=0.0)
    want = list(jd.stream(batch_size=4, seed=5))
    got = list(td.stream(batch_size=4, seed=5, device="cpu"))
    assert [len(b["has_boat"]) for b in got] == [len(b["has_boat"]) for b in want]
    rows = np.concatenate([b["closest_boat"] for b in got])
    # the boat at BG99 (d = 1) and the quiet recording (d = 0)
    assert set(rows.tolist()) == {float(np.float32(2 * 1 / 100 - 1)), -1.0}
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["closest_boat"], w["closest_boat"])
        assert_spectrograms_close(w["audio"], g["audio"])


def test_distance_from_bg_columns_matches_jax():
    bg = np.random.default_rng(0).uniform(-1, 1, (20, 101)) * (np.random.default_rng(1).uniform(size=(20, 101)) > 0.9)
    bg[3] = 0.0
    np.testing.assert_array_equal(tesrf.distance_from_bg_columns(bg), jesrf.distance_from_bg_columns(bg))
    assert tesrf.distance_from_bg_columns(bg)[3] == -1.0


def test_signaltonoise_matches_jax():
    x = np.random.default_rng(0).normal(0.1, 1, (50, 3))
    np.testing.assert_array_equal(twhale.signaltonoise(x), jwhale.signaltonoise(x))
    assert twhale.signaltonoise(np.ones(4)) == 0
