"""The port's ``make_mnist_cf_matrix`` / ``show_cf_matrix`` and
``morphomnist_attribute_shap`` CLIs on the CPU, on the artifacts that
``test_torch_cli_explain.py``'s ``trained`` fixture trains (16-row splits,
narrow models): the matrix pickle has the JAX script's keys and
``show_cf_matrix`` prints what the JAX script prints for it; the SHAP
arrays of both models have shape (N, 10, 3) and repeat under the seeded
draws.
"""
import pickle
import subprocess
import sys

import numpy as np
import pytest
from test_torch_cli_explain import REPO, run, trained  # noqa: F401  (a fixture)


def test_matrix_pickle_and_its_printout_match_the_jax_script(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "matrix.pkl"
    run("make_mnist_cf_matrix", "--data-dir", data, "--model-dir", models, "--per-digit", 1,
        "--sample-points", 10, "--metric", "ssim", "--output", out)
    with open(out, "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == {"matrix", "counts", "metric"} and saved["metric"] == "ssim"
    assert saved["matrix"].shape == saved["counts"].shape == (10, 10)
    assert np.isnan(np.diag(saved["matrix"])).all() and (np.diag(saved["counts"]) == 0).all()
    assert (np.isnan(saved["matrix"]) == (saved["counts"] == 0)).all()

    # the same printout as the JAX script, for this pickle and one with a NaN-free row
    other = tmp_path / "other.pkl"
    with open(other, "wb") as f:
        m = np.arange(100, dtype=float).reshape(10, 10) / 7.0
        m[2, 5] = np.nan
        pickle.dump({"matrix": m, "counts": np.ones((10, 10)), "metric": "mixture"}, f)
    for path, metric in ((out, "ssim"), (other, None)):
        flags = ["--matrix", str(path)] + (["--metric", metric] if metric else [])
        want = subprocess.run([sys.executable, str(REPO / "show_cf_matrix.py"), *flags], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert want.returncode == 0, want.stderr
        assert run("show_cf_matrix", *flags, device=False) == want.stdout
    with pytest.raises(SystemExit, match="was built with metric='ssim'"):
        run("show_cf_matrix", "--matrix", out, "--metric", "mse", device=False)


def test_shap_writes_both_models_arrays(trained, tmp_path, monkeypatch):
    data, models, _ = trained
    monkeypatch.chdir(tmp_path)
    args = ("--data-dir", data, "--model-dir", models, "--limit", 3, "--n-background", 8, "--n-mc", 2,
            "--n-steps", 4)
    log = run("morphomnist_attribute_shap", *args)
    first = {}
    for name in ("bigan", "vae"):
        assert f"saved {name}_attribute_shap.npy (mean |shap|: " in log
        first[name] = np.load(tmp_path / f"{name}_attribute_shap.npy")
        assert first[name].shape == (3, 10, 3) and np.isfinite(first[name]).all()
    assert np.abs(first["bigan"]).max() > 0
    run("morphomnist_attribute_shap", *args)  # the draws come from a seeded generator
    np.testing.assert_array_equal(np.load(tmp_path / "bigan_attribute_shap.npy"), first["bigan"])
