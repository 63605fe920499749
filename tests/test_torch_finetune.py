"""The port's encoder fine-tuner (``imagecfgen_torch/cf/finetune.py``) against
the JAX package's (``imagecfgen_tpu/cf/finetune.py``), on a narrow MNIST
BiGAN (every width an eighth, latent 32) with weights drawn with numpy at
N(0, 1/sqrt(fan_in)) and carried across by ``core.convert``.

- one epoch of 16 rows at batch 8 (two Adam steps at lr 1e-3), the JAX
  epoch's permutation (``jax.random.permutation`` under its key) injected,
  for ``mse`` and ``ssim``: the epoch's mean metrics to 1e-5 relative, and
  E's parameters after it as ``tests/test_torch_vae.py`` holds a step's
  (Adam's first update is ``lr * g / |g|``): within ``0.02 * lr`` plus 1e-5
  relative for all but one element in a thousand, none off by more than
  ``2 * lr`` a step;
- ``remat=True`` (``torch.utils.checkpoint``) gives E's parameters of
  ``remat=False`` within 1e-6;
- G is untouched, bit for bit, and has no ``.grad``;
- the fit never calls ``fused_encoder_forward`` (E needs a gradient: its
  ``PlanSequential`` runs), so its ``launches`` does not move.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_layers import narrow_config, redraw

from imagecfgen_tpu.cf.finetune import EncoderFinetuner as JFinetuner
from imagecfgen_tpu.cf.finetune import FinetuneConfig as JConfig
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_torch.cf.finetune import EncoderFinetuner, FinetuneConfig
from imagecfgen_torch.core.convert import bigan_params_from_jax, encoder_state_dict_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

N, B, LR = 16, 8, 1e-3


def data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (N, 28, 28, 1)).astype(np.float32)
    a = {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, N)]}
    a.update({k: rng.uniform(-1, 1, N).astype(np.float32) for k in ("thickness", "intensity", "slant")})
    return x, a


@pytest.fixture(scope="module")
def weights():
    x, a = data()
    rng = np.random.default_rng(1)
    jm = jbigan.BiGAN(narrow_config(jbigan, "mnist"))
    key = jax.random.PRNGKey(0)
    pE = redraw(jm.encoder.init({"params": key}, jnp.asarray(x[:2]), {k: v[:2] for k, v in a.items()})["params"], rng)
    pG = redraw(jm.generator.init({"params": key}, jnp.zeros((2, 1, 1, 32)),
                                  {k: v[:2] for k, v in a.items()})["params"], rng)
    return jm, pE, pG


def port_finetuner(pE, pG, **kw):
    model = bigan_params_from_jax(pE, pG, narrow_config(tbigan, "mnist"), "cpu")
    return EncoderFinetuner(model, FinetuneConfig(learning_rate=LR, batch_size=B, **kw), "cpu")


@pytest.mark.parametrize("metric", ["mse", "ssim"])
def test_one_epoch_follows_jax(weights, metric):
    jm, pE, pG = weights
    x, a = data()
    jft = JFinetuner(jm, pG, JConfig(learning_rate=LR, batch_size=B, metric=metric))
    key = jax.random.PRNGKey(5)
    state = jft.init_state(jax.tree_util.tree_map(jnp.array, pE), jax.random.PRNGKey(1))
    state, jmetrics = jft.fit_epoch(state, jft.upload_dataset(x, a), key)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, N)))

    ft = port_finetuner(pE, pG, metric=metric)
    metrics = ft.fit_epoch(ft.upload_dataset(x, a), perm=perm)
    assert ft.step == N // B and ft.opt.count == N // B
    for k in ("rec", "latent"):
        np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=1e-5, err_msg=k)

    want = encoder_state_dict_from_jax(jax.device_get(state.params_E))
    start = encoder_state_dict_from_jax(pE)
    got = dict(ft.bigan.encoder.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        have, w = got[name].detach().numpy(), w.numpy()
        err = np.abs(have - w)
        tight = err <= 0.02 * LR + 1e-5 * np.abs(w)
        assert tight.mean() >= 0.999, f"{name}: {(~tight).sum()} of {tight.size} elements off"
        assert err.max() <= 2 * LR * ft.step, f"{name}: off by {err.max()}"
        assert not np.array_equal(have, start[name].numpy()), f"{name} did not move"


def test_remat_matches_no_remat_and_leaves_g_alone(weights, monkeypatch):
    _, pE, pG = weights
    x, a = data(seed=2)
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(3))
    calls = []
    real = tbigan.fused_encoder_forward

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tbigan, "fused_encoder_forward", counting)
    before = fused_encoder_forward.launches
    out = {}
    for remat in (False, True):
        ft = port_finetuner(pE, pG, metric="ssim", remat=remat)
        g0 = {k: v.clone() for k, v in ft.bigan.generator.state_dict().items()}
        e0 = {k: v.clone() for k, v in ft.bigan.encoder.state_dict().items()}
        m = ft.fit_epoch(ft.upload_dataset(x, a), perm=perm)
        for k, v in ft.bigan.generator.state_dict().items():
            assert torch.equal(v, g0[k]), f"G's {k} moved"
        assert all(p.grad is None for p in ft.bigan.generator.parameters())
        assert all(not torch.equal(v, e0[k]) for k, v in ft.bigan.encoder.state_dict().items())
        out[remat] = ({k: v.clone() for k, v in ft.bigan.encoder.state_dict().items()}, m)
    for k, v in out[False][0].items():
        np.testing.assert_allclose(out[True][0][k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert abs(out[True][1]["rec"] - out[False][1]["rec"]) < 1e-6
    assert calls == [] and fused_encoder_forward.launches == before


def test_epoch_draws_its_permutation_from_the_generator(weights):
    _, pE, pG = weights
    x, a = data(seed=4)
    runs = []
    for _ in range(2):
        ft = port_finetuner(pE, pG)
        ft.fit_epoch(ft.upload_dataset(x, a))
        runs.append([p.detach().clone() for p in ft.bigan.encoder.parameters()])
    assert all(torch.equal(p, q) for p, q in zip(*runs))


def test_small_sets_and_unknown_metrics_are_refused(weights):
    _, pE, pG = weights
    x, a = data()
    with pytest.raises(ValueError, match="unknown metric"):
        port_finetuner(pE, pG, metric="l1")
    ft = port_finetuner(pE, pG)
    ft.fit_epoch(ft.upload_dataset(x, a))  # fixes the batch at 8
    with pytest.raises(ValueError, match="smaller than one batch"):
        ft.fit_epoch(ft.upload_dataset(x[:4], {k: v[:4] for k, v in a.items()}))
