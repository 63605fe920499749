"""The port's fused dense + LeakyReLU against the JAX package's.

Same inputs (numpy, from a seed) go through ``imagecfgen_tpu`` and
``imagecfgen_torch``; the JAX kernel runs in Pallas interpret mode (aligned
shapes) or through its XLA path (unaligned shapes), as
``tests/test_pallas_ops.py`` runs it. Tolerance 1e-5 absolute and relative:
both sides sum at most 2048 f32 products in different orders, with outputs
of order 1.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.ops.pallas.fused_dense import fused_dense_lrelu as j_fused
from imagecfgen_torch.ops import fused_dense as tfd

TOL = 1e-5


def _inputs(m, k, n, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)  # JAX layout (in, out)
    b = rng.normal(0, 0.5, n).astype(np.float32) if bias else np.zeros(n, np.float32)
    return x, w, b


def _port(x, w, b):
    """The same arrays in the port's layout: the dense kernel as (out, in)."""
    return torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(b)


@pytest.mark.parametrize("shape", [(128, 512, 512), (128, 2048, 512)], ids=["one_k_tile", "multi_k"])
def test_matches_jax_interpret(shape):
    x, w, b = _inputs(*shape, seed=0)
    ref = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 0.2, True)
    out = tfd.fused_dense_lrelu(*_port(x, w, b), 0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_unaligned_matches_jax_xla_path(slope):
    x, w, b = _inputs(100, 300, 200, seed=1)
    ref = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), slope)
    out = tfd.fused_dense_lrelu(*_port(x, w, b), slope)
    assert tuple(out.shape) == (100, 200)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_gradients_match_jax_custom_vjp():
    x, w, b = _inputs(128, 512, 512, seed=2)

    def loss(x, w, b):
        return (j_fused(x, w, b, 0.2, True) ** 2).mean()

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (t.requires_grad_() for t in _port(x, w, b))
    (tfd.fused_dense_lrelu(tx, tw, tb, 0.2) ** 2).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL, atol=1e-8)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw).T, rtol=TOL, atol=1e-8)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=TOL, atol=1e-8)


def test_gradients_match_autograd_of_plain_version():
    x, w, b = _inputs(16, 40, 24, seed=3)
    fused = [t.requires_grad_() for t in _port(x, w, b)]
    plain = [t.detach().clone().requires_grad_() for t in fused]
    (tfd.fused_dense_lrelu(*fused, 0.1).sin().sum()).backward()
    (tfd.fused_dense_reference(*plain, 0.1).sin().sum()).backward()
    for a, r in zip(fused, plain):
        torch.testing.assert_close(a.grad, r.grad, rtol=TOL, atol=1e-7)


def test_cpu_tensors_take_the_plain_version():
    x, w, b = _port(*_inputs(100, 300, 200, seed=4))
    before = tfd.fused_dense_lrelu.launches
    out = tfd.fused_dense_lrelu(x, w, b, 0.2)
    assert tfd.fused_dense_lrelu.launches == before
    assert torch.equal(out, tfd.fused_dense_reference(x, w, b, 0.2))


def test_other_devices_raise_rather_than_fall_back():
    x, w, b = (t.to("meta") for t in _port(*_inputs(4, 8, 6, seed=5)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfd.fused_dense_lrelu(x, w, b)


@pytest.mark.parametrize("bad", ["k", "bias", "rank", "device"])
def test_shape_and_device_checks(bad):
    x, w, b = _port(*_inputs(4, 8, 6, seed=6))
    if bad == "k":
        w = w[:, :7]
    elif bad == "bias":
        b = b[:5]
    elif bad == "rank":
        x = x.reshape(2, 2, 8)
    else:
        b = b.to("meta")
    with pytest.raises(ValueError, match="fused_dense_lrelu"):
        tfd.fused_dense_lrelu(x, w, b)


def test_cuda_source_names_the_kernel_it_replaces():
    src = Path(tfd.__file__).resolve().parents[1] / "csrc" / "fused_dense.cu"
    text = src.read_text()
    assert "_pallas_forward" in text and "_matmul_kernel" in text
    assert "sm_90a" in text
    assert "extern \"C\" int fused_dense_run" in text
    lowered = text.lower()
    assert not any(lib in lowered for lib in ("cublas", "cudnn", "#include <torch"))
