"""The port's SSIM (``imagecfgen_torch/ops/ssim.py``) against the JAX
package's (``imagecfgen_tpu/ops/ssim.py``): the same numpy batches, one and
three channels, both ``size_average`` modes, within 1e-6 absolute (each is a
float32 mean of products of Gaussian blurs summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.ops.ssim import ssim as jssim
from imagecfgen_torch.ops.ssim import ssim

TOL = 1e-6


def pair(c, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, 28, 28, c)).astype(np.float32)
    y = np.clip(x + rng.normal(0, noise, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("c", [1, 3])
def test_ssim_matches_jax(c, size_average):
    x, y = pair(c, seed=c)
    want = np.asarray(jssim(jnp.asarray(x), jnp.asarray(y), size_average=size_average))
    got = ssim(torch.from_numpy(x), torch.from_numpy(y), size_average=size_average).numpy()
    assert got.shape == want.shape == (() if size_average else (3,))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("data_range", [1.0, 2.0])
def test_ssim_data_range_and_identity_match_jax(data_range):
    x, y = pair(1, seed=7, noise=0.1)
    x, y = x * data_range, y * data_range
    for a, b in ((x, y), (x, x)):
        want = float(jssim(jnp.asarray(a), jnp.asarray(b), data_range=data_range))
        got = float(ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=data_range))
        assert abs(got - want) <= TOL
    assert abs(float(ssim(torch.from_numpy(x), torch.from_numpy(x), data_range=data_range)) - 1.0) <= 1e-5


def test_ssim_gradient_flows():
    """The fine-tuner differentiates 1 - SSIM through the reconstruction."""
    x, y = pair(1, seed=3)
    yt = torch.from_numpy(y).requires_grad_(True)
    (1.0 - ssim(torch.from_numpy(x), yt)).backward()
    assert torch.isfinite(yt.grad).all() and yt.grad.abs().max() > 0
