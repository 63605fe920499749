"""The port's CNN classifiers against the JAX package's, with the JAX params
carried across by ``classifier_params_from_jax``.

Weights are redrawn with numpy at N(0, 1/sqrt(fan_in)) so activations stay
O(1) through the stacks. Tolerance 2e-4 absolute and 1e-4 relative: up to
seven convs and two dense layers summed in f32 in another order, as in
``tests/test_torch_bigan.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.models import classifier as jclf
from imagecfgen_torch.core.convert import classifier_params_from_jax
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import layers
from imagecfgen_torch.ops.fused_dense import fused_dense_reference

CONFIGS = {
    "mnist": (lambda m: m.mnist_classifier_config()),
    "mnist_oracle": (lambda m: m.mnist_oracle_config()),
    "audio": (lambda m: m.audio_mnist_classifier_config(10)),
    "audio_subject_half": (lambda m: m.audio_mnist_classifier_config(60, width=0.5)),
    "audio_narrow": (lambda m: m.audio_mnist_classifier_config(10, width=0.125)),
    "narw": (lambda m: m.narw_classifier_config()),
    "narw_narrow": (lambda m: m.narw_classifier_config(3, width=0.125)),
}


def _redraw(params, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name else 0.1
        return rng.normal(0, std, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def _pair(config, seed=0, b=4):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = CONFIGS[config](jclf), CONFIGS[config](tclf)
    x = rng.uniform(-1, 1, (b, *jcfg.image_size, jcfg.image_channels)).astype(np.float32)
    jm = jclf.CNNClassifier(jcfg)
    params = _redraw(jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"], rng)
    tm = classifier_params_from_jax(params, tcfg, device="cpu")
    return jm, params, tm, x


@pytest.mark.parametrize("config", ["audio_narrow", "mnist"])
def test_classifier_matches_jax(config):
    jm, params, tm, x = _pair(config)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_dense_lrelu_head_goes_through_fused_dense(monkeypatch):
    """The peephole sends the dense 1024 + LeakyReLU head (and nothing else)
    to ``fused_dense_lrelu``, under the JAX parameter names."""
    jm, params, tm, x = _pair("audio_narrow", seed=1)
    calls = []

    def record(x, w, b, slope):
        calls.append((tuple(x.shape), tuple(w.shape), slope))
        return fused_dense_reference(x, w, b, slope)

    monkeypatch.setattr(layers, "fused_dense_lrelu", record)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert calls == [((4, 512), (128, 512), 0.2)]
    names = {k for k, _ in tm.trunk.named_parameters()}
    assert {"dense_0_kernel", "dense_0_bias", "dense_1_kernel", "dense_1_bias"} <= names
    assert set(params["trunk"]) == names
    ref = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_lone_dense_is_not_fused(monkeypatch):
    _, _, tm, x = _pair("mnist", seed=2)
    monkeypatch.setattr(layers, "fused_dense_lrelu", lambda *a: pytest.fail("fused a lone dense"))
    with torch.no_grad():
        assert tuple(tm(torch.from_numpy(x)).shape) == (4, 10)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_config_matches_jax(config):
    j, t = CONFIGS[config](jclf), CONFIGS[config](tclf)
    assert (t.plan, t.image_size, t.image_channels, t.n_classes, t.init_std) == (
        j.plan, j.image_size, j.image_channels, j.n_classes, j.init_std)


def test_audio_classifier_head_shapes():
    """flatten (2, 2, w(1024)) -> dense w(1024) -> dense classes, at half width."""
    cfg = tclf.audio_mnist_classifier_config(10, width=0.5)
    m = tclf.CNNClassifier(cfg, device="cpu", rng=torch.Generator().manual_seed(0))
    assert tuple(m.trunk.dense_0_kernel.shape) == (512, 2048)
    assert tuple(m.trunk.dense_1_kernel.shape) == (10, 512)
    assert m.trunk.out_shape == (10,)
