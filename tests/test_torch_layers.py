"""The port's conv primitives and layer library against the JAX package's.

Inputs and weights are numpy draws from a seed, handed to both packages.
Tolerance: 1e-5 relative and absolute for small modules and 2e-5 for single
convs (f32 sums in another order); 2e-4 absolute and 1e-4 relative for
multi-layer stacks, as in ``tests/test_pallas_ops.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_MNIST_SPEC
from imagecfgen_tpu.models import layers as jl
from imagecfgen_tpu.models.bigan import mnist_bigan_config as j_mnist_cfg
from imagecfgen_tpu.ops import conv as jconv
from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeSpec
from imagecfgen_torch.core.convert import plan_state_dict_from_jax
from imagecfgen_torch.models import layers as tl
from imagecfgen_torch.ops import conv as tconv


def _np(x):
    return np.array(jax.device_get(x))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# (in hw, channels in/out, kernel, stride, padding)
CONV_CASES = [
    ((28, 28), (5, 8), 3, 2, 1),
    ((14, 14), (4, 6), 4, 2, 1),
    ((3, 3), (6, 7), 4, 2, 1),
    ((1, 1), (8, 4), 1, 2, 0),
    ((12, 10), (3, 5), 5, 1, 0),
    ((9, 9), (2, 3), 4, 2, 0),
]


@pytest.mark.parametrize("hw,ch,k,s,p", CONV_CASES)
def test_conv2d_matches_jax(hw, ch, k, s, p):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, ch[0])).astype(np.float32)
    w = rng.normal(size=(k, k, *ch)).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), s, p)
    out = tconv.conv2d(torch.from_numpy(x), tconv.kernel_from_hwio(w), s, p)
    assert out.shape == ref.shape
    assert out.shape[1] == tconv.conv_out_size(hw[0], k, s, p) == jconv.conv_out_size(hw[0], k, s, p)
    _close(out.numpy(), _np(ref), 2e-5)


# (in hw, channels in/out, kernel, stride, padding, output_padding)
CONVT_CASES = [
    ((1, 1), (6, 5), 3, 1, 0, 0),
    ((3, 3), (5, 4), 3, 2, 0, 0),
    ((7, 7), (4, 3), 3, 2, 1, 0),
    ((25, 25), (3, 1), 4, 1, 0, 0),
    ((4, 4), (4, 3), 5, 2, 2, 1),
    ((5, 6), (2, 3), 3, 2, 1, 1),
]


@pytest.mark.parametrize("hw,ch,k,s,p,op", CONVT_CASES)
def test_conv_transpose2d_matches_jax(hw, ch, k, s, p, op):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, ch[0])).astype(np.float32)
    w = rng.normal(size=(k, k, *ch)).astype(np.float32)
    ref = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), s, p, output_padding=op)
    out = tconv.conv_transpose2d(torch.from_numpy(x), tconv.kernel_transpose_from_hwio(w), s, p,
                                 output_padding=op)
    assert out.shape == ref.shape
    assert out.shape[1] == tconv.conv_transpose_out_size(hw[0], k, s, p, op)
    _close(out.numpy(), _np(ref), 2e-5)


def test_conv_transpose2d_rejects_large_padding():
    with pytest.raises(ValueError):
        tconv.conv_transpose2d(torch.zeros(1, 2, 2, 1), torch.zeros(1, 1, 2, 2), 1, 2)


def _attrs(b, rng, soft=False):
    digit = rng.dirichlet(np.ones(10), b) if soft else np.eye(10)[rng.integers(0, 10, b)]
    a = {"digit": digit.astype(np.float32)}
    for k in ("thickness", "intensity", "slant"):
        a[k] = rng.uniform(-1, 1, b).astype(np.float32)
    return a


@pytest.mark.parametrize("image_size,embed_hw", [((28, 28), (16, 16)), ((20, 12), (16, 16)),
                                                  ((32, 32), (8, 4))])
def test_attribute_channels_matches_flax(image_size, embed_hw):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (3, *image_size, 1)).astype(np.float32)
    a = _attrs(3, rng)
    dim = embed_hw[0] * embed_hw[1]
    mod = jl.AttributeChannels(J_MNIST_SPEC, image_size, dim, embed_hw)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), a)["params"]
    ref = mod.apply({"params": params}, jnp.asarray(x), a)
    tmod = tl.AttributeChannels(MNIST_SPEC, image_size, dim, embed_hw, device="cpu")
    tmod.embed_digit.data = torch.from_numpy(_np(params["embed_digit"]["embedding"]))
    out = tmod(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in a.items()})
    assert out.shape == ref.shape == (3, *image_size, 5)
    _close(out.detach().numpy(), _np(ref))


def test_attribute_vectors_matches_flax_on_soft_digits():
    rng = np.random.default_rng(3)
    a = _attrs(4, rng, soft=True)
    mod = jl.AttributeVectors(J_MNIST_SPEC, 16)
    params = mod.init(jax.random.PRNGKey(1), a)["params"]
    ref = mod.apply({"params": params}, a)
    tmod = tl.AttributeVectors(MNIST_SPEC, 16, device="cpu")
    tmod.embed_digit.data = torch.from_numpy(_np(params["embed_digit"]))
    out = tmod({k: torch.from_numpy(v) for k, v in a.items()})
    assert out.shape == ref.shape == (4, 19)
    _close(out.detach().numpy(), _np(ref))


def test_attribute_spec_orders_by_name():
    spec = AttributeSpec.create(zeta=0, alpha=3, mid=0)
    assert spec.names == ("alpha", "mid", "zeta")
    assert [a.name for a in spec.categorical] == ["alpha"]
    assert MNIST_SPEC.names == J_MNIST_SPEC.names


PLANS = {
    # the MNIST discriminator's x tower: dropout (identity in eval) and bn
    "dx_bn": (j_mnist_cfg().dx_plan, (28, 28, 5)),
    # dense stem -> reshape -> deconv -> tanh (audio-style generator)
    "dense_stem": ((("dense", 64), ("reshape", (4, 4, 4)), ("lrelu", 0.2),
                    ("convT", 3, 5, 2, 2, 1), ("tanh",)), (12,)),
    # conv -> flatten -> dense+lrelu (classifier-style head) -> sigmoid
    "dense_head": ((("conv", 8, 3, 2, 1), ("lrelu", 0.2), ("flatten",), ("dense", 16),
                    ("lrelu", 0.2), ("drop", 0.5), ("dense", 4), ("sigmoid",)), (9, 9, 3)),
    "mnist_gen": (j_mnist_cfg(latent_dim=16).gen_plan, (1, 1, 35)),
}


def _scaled_params(params, rng):
    """Replace every leaf with N(0, 1/sqrt(fan_in)) so activations stay O(1)
    through the stack (the configs' init would shrink them to ~0)."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_sequential_matches_flax(name):
    plan, in_shape = PLANS[name]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, *in_shape)).astype(np.float32)
    mod = jl.PlanSequential(plan, init_std=0.05)
    variables = mod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = _scaled_params(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.device_get(variables.get("batch_stats", {})),
    )
    ref = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    tmod = tl.PlanSequential(plan, in_shape, 0.05, device="cpu")
    tmod.load_state_dict(plan_state_dict_from_jax(params, stats))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape == (3, *tmod.out_shape)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-4, atol=2e-4)


def test_plan_sequential_rejects_unknown_op():
    with pytest.raises(ValueError):
        tl.PlanSequential((("pool", 2),), (4, 4, 1), device="cpu")
