"""``--help`` of ``test_torch_cli_explain.py``'s CLIs (with no card and with
matplotlib, PIL, pandas and tqdm unimportable), and the port's
``mnist_cf_explain``, ``mnist_cf_comparisons``, ``finetune_mnist_bigan`` and
``mnist_reconstructions`` CLIs on the CPU, on the artifacts that
``test_torch_cli_explain.py``'s ``trained`` fixture trains (16-row splits,
narrow models, the explainers at 5 steps): the PNG strips decode to their
sizes, the fine-tuned checkpoint moves E only and the reconstructions render
it; and the SHAP estimator with the JAX script's draws injected equals the JAX
script's ``expected_gradients`` within 1e-4 relative plus 1e-4 of the
largest value.
"""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli_explain import (  # noqa: F401  (trained: a fixture)
    BATCH,
    CLIS,
    REPO,
    STEPS,
    TENSOR_CLIS,
    narrow_models,
    run,
    trained,
)
from test_torch_explain import make_models

from imagecfgen_torch.cf.engine import CounterfactualEngine
from imagecfgen_torch.cli.common import bigan_from_state, load_bigan, load_mnist_training_data, read_png
from imagecfgen_torch.core.checkpoint import checkpoint_format
from imagecfgen_torch.models import bigan as tbigan


@pytest.fixture(scope="module")
def help_texts():
    """Every new CLI's ``--help``, in one process with no card and with
    matplotlib, PIL, pandas and tqdm blocked."""
    code = (
        "import contextlib, importlib.abc, io, json, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'PIL', 'pandas', 'tqdm'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "out = {}\n"
        f"for name in {list(CLIS)!r}:\n"
        "    buf = io.StringIO()\n"
        "    sys.argv = [name, '--help']\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            runpy.run_module('imagecfgen_torch.cli.' + name, run_name='__main__')\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (name, e.code)\n"
        "    out[name] = buf.getvalue()\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CLIS)
def test_help_needs_no_card_and_no_missing_package(name, help_texts):
    text = help_texts[name]
    assert text.startswith("usage:")
    assert ("--device" in text) == (name in TENSOR_CLIS)


def test_cf_explain_and_comparisons_write_their_strips(trained, tmp_path):
    data, models, _ = trained
    log = run("mnist_cf_explain", "--data-dir", data, "--model-dir", models, "--steps", STEPS,
              "--sample-points", 12, "--output", tmp_path / "explain.png")
    assert re.search(r"best mixture weight: (nan|[0-9.]+)", log)
    h, w = read_png(str(tmp_path / "explain.png")).shape
    assert h == 3 * 28 and w in (28 * k for k in range(1, 5))
    run("mnist_cf_comparisons", "--data-dir", data, "--model-dir", models, "--n-images", 3,
        "--steps", STEPS, "--output", tmp_path / "comparisons.png")
    assert read_png(str(tmp_path / "comparisons.png")).shape == (5 * 28, 3 * 28)


def test_finetune_moves_e_only_and_reconstructions_render_it(trained, tmp_path, monkeypatch):
    data, models, _ = trained
    monkeypatch.chdir(tmp_path)
    src = str(models / "mnist-bigan.tar")
    for metric in ("mse", "ssim"):
        log = run("finetune_mnist_bigan", "--data-dir", data, "--model-file", src, "--steps", 2,
                  "--metric", metric, "--lr", 1e-3, "--batch-size", BATCH)
        assert len(re.findall(rf"epoch [12]/2: {metric}=[0-9.]+ latent=[0-9.]+ \([0-9.]+ steps/s\)", log)) == 2
        out = tmp_path / f"mnist-bigan-finetuned-{metric}.tar"
        assert checkpoint_format(str(out)) == "torch"
        before, scaler0, _ = load_bigan(src, "cpu")
        after, scaler1, meta = load_bigan(str(out), "cpu")
        assert meta["finetuned"] == metric and meta["kind"] == "bigan"
        assert scaler1.state_dict() == scaler0.state_dict()
        assert all(not torch.equal(after["E"][k], v) for k, v in before["E"].items())
        for part in ("G", "D"):
            assert all(torch.equal(after[part][k], v) for k, v in before[part].items())
        assert after["step"] == before["step"] and after["opt_eg"]["count"] == before["opt_eg"]["count"]
        with narrow_models():
            engine = CounterfactualEngine(bigan_from_state(after, tbigan.mnist_bigan_config(), "cpu"),
                                          None, scaler1, "cpu")
        x, attrs, _ = load_mnist_training_data(str(data), "test")
        assert engine.reconstruct(x[:4], {k: v[:4] for k, v in attrs.items()}).shape == (4, 28, 28, 1)
    log = run("mnist_reconstructions", "--data-dir", data, "--model-files", src,
              "mnist-bigan-finetuned-mse.tar", "mnist-bigan-finetuned-ssim.tar", "--n-images", 6,
              "--output", "recon.png")
    assert read_png(str(tmp_path / "recon.png")).shape == (4 * 28, 6 * 28)
    assert "row 3: mnist-bigan-finetuned-mse" in log


def test_shap_estimator_matches_the_jax_script():
    from imagecfgen_torch.cli.morphomnist_attribute_shap import expected_gradients, unpack

    jfns, tfns, _, _, _ = make_models(seed=4)
    _, jG, jC = jfns
    _, tG, tC = tfns
    rng = np.random.default_rng(0)
    bg = rng.uniform(-1, 1, (8, 13)).astype(np.float32)
    bg[:, :10] = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    a13 = bg[3:4] * 0.5 + 0.1
    n_steps, n_mc = 4, 3

    # the JAX script's expected_gradients, its draws kept
    key = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(key, 3)
    bidx = jax.random.randint(k1, (n_steps,), 0, 8)
    ts = jax.random.uniform(k2, (n_steps,))
    step_keys = jax.random.split(k3, n_steps)

    def junpack(a):
        return {"digit": a[:, :10], "thickness": a[:, 10], "intensity": a[:, 11], "slant": a[:, 12]}

    def class_probs(a, k):
        def one(kk):
            z = jax.random.normal(kk, (a.shape[0], 1, 1, 32))
            return jax.nn.softmax(jC(jG(z, junpack(a))), axis=1)
        return jax.vmap(one)(jax.random.split(k, n_mc)).mean(axis=0)

    def one_step(b_i, t, k):
        base = jnp.asarray(bg)[b_i][None]
        point = base + t * (jnp.asarray(a13) - base)
        grad = jax.jacrev(lambda a: class_probs(a, k).sum(axis=0))(point)
        return grad[:, 0, :] * (jnp.asarray(a13) - base)[0]

    want = np.asarray(jax.jit(jax.vmap(one_step))(bidx, ts, step_keys).mean(axis=0))
    z = np.stack([np.stack([np.asarray(jax.random.normal(kk, (1, 1, 1, 32)))[0]
                            for kk in jax.random.split(k, n_mc)]) for k in step_keys])
    got = expected_gradients(tG, tC, torch.from_numpy(a13), torch.from_numpy(bg),
                             torch.from_numpy(np.array(bidx)).long(), torch.from_numpy(np.array(ts)),
                             torch.from_numpy(z)).detach().numpy()
    assert got.shape == want.shape == (10, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert np.abs(want[:, 10:]).min() > 0
    assert set(unpack(torch.zeros(2, 13))) == {"digit", "thickness", "intensity", "slant"}
