"""The port's AudioMNIST data path against the JAX package's, on the CPU: the
STFT, its inverse and Griffin-Lim, the spectrogram statistics, the
FFT resampler, the synthetic stand-in, the zip's ingest, the vocabularies and
the splits. The same numpy inputs from a seed go to both packages.

Tolerances (float32 throughout):

- ``stft`` to 2e-6 of max |X| (an FFT of 255 or 511 terms rounded in another
  order; ``torch.stft`` on the port's side, an XLA FFT on JAX's), the power
  spectrogram to 4e-6 of its max (the square doubles the relative error),
  ``istft`` to 2e-6 of max |x|;
- ``griffin_lim`` (JAX's initial phase injected) to 5e-4 of max |x| after
  its 32 iterations: each normalises ``rebuilt - m * prev`` by its modulus,
  so bins near zero pass their rounding on;
- log-spectrograms of the stand-in, in image units (after the same
  statistics): 5e-4 (the log of a power near 0 amplifies its rounding);
- ``SpectStats.compute`` fed JAX's own spectrograms: mean and std to 2e-5
  of max |x| (a float32 sum of 10^5 values, in another order; on the
  constant zero-pad columns the true std is 0 and both packages hold that
  rounding noise), ``spect_to_img``/``img_to_spect`` given the same
  statistics to 1e-6;
- the FFT resampler, the stand-in's waveforms and attributes, the zip's ingest,
  the vocabularies, the binner and the splits: bit for bit.
"""
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from imagecfgen_tpu.data import audio_mnist as jdata
from imagecfgen_tpu.ops import resample as jres
from imagecfgen_tpu.ops import spectral as jspec
from imagecfgen_tpu.ops import stft as jstft
from imagecfgen_torch.data import audio_mnist as tdata
from imagecfgen_torch.ops import resample as tres
from imagecfgen_torch.ops import spectral as tspec
from imagecfgen_torch.ops import stft as tstft

CONFIGS = {"audio_mnist": dict(n_fft=255, win_length=128, pad=96),
           "whale": dict(n_fft=511, win_length=128, hop_length=24, pad=64)}


def signals(n=3, t=8000, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 8000.0
    tone = np.sin(2 * np.pi * rng.uniform(150, 700, (n, 1)) * tt) * np.hanning(t)
    return (tone + 0.05 * rng.normal(0, 1, (n, t))).astype(np.float32)


def close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, f"off by {err:.3e} of max {top:.3e} ({err / top:.2e} > {rel:.0e})"


# ---------------------------------------------------------------- STFT


@pytest.mark.parametrize("name", CONFIGS)
def test_window_and_shapes(name):
    jc, tc = jstft.StftConfig(**CONFIGS[name]), tstft.StftConfig(**CONFIGS[name])
    np.testing.assert_allclose(tc.padded_window().numpy(), np.asarray(jc.padded_window()), atol=1e-7)
    assert (tc.hop, tc.n_freqs, tc.n_frames(8000)) == (jc.hop, jc.n_freqs, jc.n_frames(8000))
    assert tuple(tstft.spectrogram(torch.zeros(2, 8000), tc).shape) == (2, tc.n_freqs, tc.n_frames(8000))
    if name == "audio_mnist":
        w = tc.padded_window().numpy()
        assert (tc.n_freqs, tc.n_frames(8000)) == (128, 128)
        # 63 zeros, the periodic window (its first value 0), 64 zeros
        assert not w[:64].any() and not w[-64:].any() and w[64:191].all()


@pytest.mark.parametrize("name", CONFIGS)
def test_stft_matches_jax_and_its_plain_version(name):
    jc, tc = jstft.StftConfig(**CONFIGS[name]), tstft.StftConfig(**CONFIGS[name])
    x = signals()
    want = np.asarray(jstft.stft(jnp.asarray(x), jc))
    got = tstft.stft(torch.from_numpy(x), tc)
    assert got.dtype == torch.complex64
    close(got.numpy(), want, 2e-6)
    close(tstft.stft_reference(torch.from_numpy(x), tc).numpy(), want, 2e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_spectrogram_matches_jax(name):
    jc, tc = jstft.StftConfig(**CONFIGS[name]), tstft.StftConfig(**CONFIGS[name])
    x = signals(seed=1)
    close(tstft.spectrogram(torch.from_numpy(x), tc).numpy(), jstft.spectrogram(jnp.asarray(x), jc), 4e-6)
    mag = tstft.StftConfig(**CONFIGS[name], power=1.0)
    close(tstft.spectrogram(torch.from_numpy(x), mag).numpy(),
          jstft.spectrogram(jnp.asarray(x), jstft.StftConfig(**CONFIGS[name], power=1.0)), 2e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_istft_matches_jax_and_inverts(name):
    jc, tc = jstft.StftConfig(**CONFIGS[name]), tstft.StftConfig(**CONFIGS[name])
    x = signals(seed=2)
    spec = np.asarray(jstft.stft(jnp.asarray(x), jc))
    for length in (None, 8000):
        want = np.asarray(jstft.istft(jnp.asarray(spec), jc, length=length))
        close(tstft.istft(torch.from_numpy(spec), tc, length=length).numpy(), want, 2e-6)
    back = tstft.istft(tstft.stft(torch.from_numpy(x), tc), tc, length=8000).numpy()
    assert np.abs(back[:, 300:-300] - x[:, 300:-300]).max() < 1e-4  # where the windows overlap


@pytest.mark.parametrize("name", CONFIGS)
def test_griffin_lim_with_jax_initial_phase(name):
    jc, tc = jstft.StftConfig(**CONFIGS[name]), tstft.StftConfig(**CONFIGS[name])
    power = np.asarray(jstft.spectrogram(jnp.asarray(signals(2, seed=3)), jc))
    key = jax.random.PRNGKey(5)
    angle = np.asarray(jax.random.uniform(key, power.shape, minval=-jnp.pi, maxval=jnp.pi))
    want = np.asarray(jstft.griffin_lim(jnp.asarray(power), jc, rng=key, n_iter=32, length=8000))
    got = tstft.griffin_lim(torch.from_numpy(power), tc, n_iter=32, length=8000, angle=torch.from_numpy(angle))
    close(got.numpy(), want, 5e-4)
    # drawn from a generator instead: the same function of another phase, reproducible
    a = tstft.griffin_lim(torch.from_numpy(power), tc, rng=torch.Generator().manual_seed(0), n_iter=2)
    b = tstft.griffin_lim(torch.from_numpy(power), tc, rng=torch.Generator().manual_seed(0), n_iter=2)
    assert torch.equal(a, b)


def test_audio_from_log_spect_matches_jax():
    power = np.asarray(jstft.spectrogram(jnp.asarray(signals(2, seed=4)), jdata.GRIFFIN_LIM_STFT))
    log_spec = np.log(power + 1e-6).astype(np.float32)
    key = jax.random.PRNGKey(1)
    angle = np.asarray(jax.random.uniform(key, log_spec.shape, minval=-jnp.pi, maxval=jnp.pi))
    want = np.asarray(jdata.audio_from_log_spect(jnp.asarray(log_spec), rng=key))
    got = tdata.audio_from_log_spect(torch.from_numpy(log_spec), angle=torch.from_numpy(angle))
    close(got.numpy(), want, 5e-4)


# ---------------------------------------------------------- statistics


@pytest.fixture(scope="module")
def stand_ins():
    """Both packages' synthetic stand-ins at two runs a (subject, digit)."""
    return jdata.AudioMNISTData(None, synthetic_runs=2), tdata.AudioMNISTData(None, synthetic_runs=2)


@pytest.fixture(scope="module")
def jax_spects(stand_ins):
    jd, _ = stand_ins
    return jd.all_spectrograms(excluded_runs=jd.training_excluded_runs)


def test_spect_stats_from_jax_spectrograms(jax_spects):
    spects = jax_spects[0]
    want = jspec.SpectStats.compute(jnp.asarray(spects))
    got = tspec.SpectStats.compute(torch.from_numpy(spects))
    top = np.abs(spects).max()
    for part in ("mean", "std"):
        have = getattr(got, part)
        assert tuple(have.shape) == (1, 1, 128) and have.dtype == torch.float32
        np.testing.assert_allclose(have.numpy(), np.asarray(getattr(want, part)), rtol=0, atol=2e-5 * top)
    same = tspec.SpectStats(torch.from_numpy(np.asarray(want.mean)), torch.from_numpy(np.asarray(want.std)))
    img = same.spect_to_img(torch.from_numpy(spects))
    jimg = np.asarray(want.spect_to_img(jnp.asarray(spects)))
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-6)
    assert img.abs().max() <= 1.0
    np.testing.assert_allclose(same.img_to_spect(img).numpy(), np.asarray(want.img_to_spect(jnp.asarray(jimg))),
                               rtol=1e-6, atol=1e-6 * top)


def test_stand_in_spectrograms_match_jax(stand_ins, jax_spects):
    jd, td = stand_ins
    spects, attrs, idx = jax_spects
    got, tattrs, tidx = td.all_spectrograms(excluded_runs=td.training_excluded_runs, device="cpu")
    np.testing.assert_array_equal(tidx, idx)
    for k in attrs:
        np.testing.assert_array_equal(tattrs[k], attrs[k])
    stats = jspec.SpectStats.compute(jnp.asarray(spects))
    same = tspec.SpectStats(torch.from_numpy(np.asarray(stats.mean)), torch.from_numpy(np.asarray(stats.std)))
    close(same.spect_to_img(got).numpy(), np.asarray(stats.spect_to_img(jnp.asarray(spects))), 5e-4)
    batch = next(td.stream(batch_size=5, excluded_runs=td.validation_excluded_runs, seed=3, device="cpu"))
    jbatch = next(jd.stream(batch_size=5, excluded_runs=jd.validation_excluded_runs, seed=3))
    assert set(batch) == set(jbatch)
    for k in jbatch:
        if k == "audio":
            close(same.spect_to_img(batch[k]).numpy(), np.asarray(stats.spect_to_img(jnp.asarray(jbatch[k]))), 5e-4)
        else:
            np.testing.assert_array_equal(batch[k], jbatch[k])


# ------------------------------------------------------------ resampling


@pytest.mark.parametrize("n, num", [(4801, 800), (800, 4800), (4801, 1601), (4800, 800), (801, 4801)],
                         ids=["down_odd", "up_even", "odd_to_odd", "down_even", "up_odd"])
def test_resample_fft_bit_for_bit(n, num):
    x = np.random.default_rng(0).normal(0, 1, (2, n))
    got = tres.resample_fft(x, num)
    np.testing.assert_array_equal(got, jres.resample_fft(x, num))
    assert got.shape == (2, num)


@pytest.mark.parametrize("n, sr", [(960, 48000), (47999, 48000), (4410, 44100), (2205, 22050), (1601, 16000),
                                   (800, 8000)])
def test_resample_rates(n, sr):
    """The rate wrapper against the JAX package's default (``filter="fft"``),
    bit for bit, and the ingest's ``_resample_to_8k`` on an int16 wav."""
    x = np.random.default_rng(1).normal(0, 1, n)
    got = tres.resample(x, sr, 8000)
    np.testing.assert_array_equal(got, jres.resample(x, sr, 8000))
    assert got.shape == (-(-n * 8000 // sr),)
    wav = (x * 3000).astype(np.int16)
    np.testing.assert_array_equal(tdata._resample_to_8k(wav, sr), jdata._resample_to_8k(wav, sr))


# ---------------------------------------------------- the data, the splits


def test_stand_in_is_the_jax_stand_in(stand_ins):
    jd, td = stand_ins
    assert set(td.raw) == set(jd.raw)
    for k in jd.raw:
        np.testing.assert_array_equal(td.raw[k], jd.raw[k], err_msg=k)
    assert td.raw["audio"].dtype == np.float32 and td.raw["audio"].shape == (1200, 8000)
    idx = np.arange(0, 1200, 7)
    for k, v in jd.encode_attrs(idx).items():
        np.testing.assert_array_equal(td.encode_attrs(idx)[k], v, err_msg=k)
    assert td.attribute_dims == jd.attribute_dims == {
        "country_of_origin": 13, "accent": 15, "digit": 10, "native_speaker": 2, "gender": 2, "age": 5}


def test_splits(stand_ins):
    jd, td = stand_ins
    assert tdata.VALIDATION_RUNS == jdata.VALIDATION_RUNS
    for prop in ("validation_runs", "training_excluded_runs", "validation_excluded_runs"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    assert td.validation_runs == [1]  # no listed run among two: the last observed one
    for runs in (None, [0], [1], [0, 1], [5]):
        np.testing.assert_array_equal(td.split_indices(runs), jd.split_indices(runs))


def test_vocab_and_binner():
    values = ["b", "a", "c", "a"]
    tv, jv = tdata.OneHotVocab(values), jdata.OneHotVocab(values)
    assert tv.categories == jv.categories == ["a", "b", "c"]
    np.testing.assert_array_equal(tv.encode(values), jv.encode(values))
    assert tv.decode(tv.encode(values)) == values
    pinned = tdata.OneHotVocab(["x"], categories=["y", "x", "z"])
    assert pinned.n == 3 and pinned.categories == ["x", "y", "z"]
    ages = np.array([20, 33, 45, 60, 28, 59])
    tb, jb = tdata.UniformBinner(ages), jdata.UniformBinner(ages)
    np.testing.assert_array_equal(tb.edges, jb.edges)
    np.testing.assert_array_equal(tb.encode(ages), jb.encode(ages))
    np.testing.assert_array_equal(tb.decode(tb.encode(ages)), jb.decode(jb.encode(ages)))


def write_zip(path, subjects=(1, 2, 3), runs=2, sr=48000):
    """A zip in the AudioMNIST layout: the metadata (with the known errors the
    ingest cleans) and ``data/NN/{digit}_NN_{run}.wav`` at ``sr``."""
    rng = np.random.default_rng(0)
    meta = {}
    for s in subjects:
        name = f"{s:02d}"
        meta[name] = {"origin": "Europe, Spanien, Madrid" if s == 1 else "Europe, Germany, Berlin",
                      "accent": "german/spanish" if s == 2 else "German", "age": "104" if s == 3 else "31",
                      "gender": "male" if s % 2 else "female", "native speaker": "no" if s == 1 else "yes"}
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("data/audioMNIST_meta.txt", json.dumps(meta))
        for s in subjects:
            for dig in range(10):
                for run in range(runs):
                    buf = io.BytesIO()
                    n = int(sr * rng.uniform(0.3, 0.9))
                    wavfile.write(buf, sr, (rng.normal(0, 3000, n)).astype(np.int16))
                    zf.writestr(f"data/{s:02d}/{dig}_{s:02d}_{run}.wav", buf.getvalue())


def test_zip_ingest_matches_jax(tmp_path):
    path = str(tmp_path / "AudioMNIST-data.zip")
    write_zip(path)
    jd, td = jdata.AudioMNISTData(path), tdata.AudioMNISTData(path)
    for k in jd.raw:
        np.testing.assert_array_equal(td.raw[k], jd.raw[k], err_msg=k)
    assert td.raw["audio"].shape == (60, 8000)
    assert set(td.raw["country_of_origin"]) == {"spain", "germany"}
    assert set(td.raw["accent"]) == {"german"} and set(td.raw["age"]) == {31, 28}
    for k, v in jd.encode_attrs(np.arange(60)).items():
        np.testing.assert_array_equal(td.encode_attrs(np.arange(60))[k], v)
