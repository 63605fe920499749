"""The height-sharded conv (``parallel/spatial.py``) at 4 gloo ranks on the
CPU against one global conv: the JAX package's ``conv2d`` and the port's own,
at ``tests/test_spatial_parallel.py``'s cases (H = 64, 16 rows a rank), to
atol 1e-5; and the refusal of a conv whose shards cannot tile."""
import numpy as np
import pytest
import torch

from imagecfgen_torch.ops.conv import conv2d, kernel_from_hwio
from imagecfgen_torch.parallel.launch import run_ranks
from imagecfgen_torch.parallel.mesh import data_mesh
from imagecfgen_torch.parallel.spatial import make_spatial_conv

WORLD = 4
CASES = [(4, 2, 1), (3, 1, 1), (5, 1, 2), (6, 2, 2)]
B, H, W, CIN, COUT = 2, 64, 32, 3, 8


def inputs(k):
    """``x`` (B, H, W, CIN) and an HWIO kernel, from numpy."""
    rng = np.random.default_rng(k)
    return (rng.normal(0, 1, (B, H, W, CIN)).astype(np.float32),
            (0.1 * rng.normal(0, 1, (k, k, CIN, COUT))).astype(np.float32))


def rank_outputs(mesh):
    """This rank's rows of each case's sharded conv."""
    out = {}
    for k, s, p in CASES:
        x, w = inputs(k)
        rows = H // mesh.world
        local = torch.from_numpy(x[:, mesh.rank * rows:(mesh.rank + 1) * rows])
        out[(k, s, p)] = make_spatial_conv(mesh, s, p, kernel=k)(local, kernel_from_hwio(w))
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    ranks = run_ranks(rank_outputs, WORLD, workdir=str(tmp_path_factory.mktemp("rdv")), timeout=120)
    return {case: np.concatenate([r[case] for r in ranks], axis=1) for case in CASES}


@pytest.mark.parametrize("k,s,p", CASES)
def test_sharded_conv_matches_global(sharded, k, s, p):
    import jax.numpy as jnp

    from imagecfgen_tpu.ops.conv import conv2d as jconv2d

    x, w = inputs(k)
    jax_ref = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), stride=s, padding=p))
    port_ref = conv2d(torch.from_numpy(x), kernel_from_hwio(w), s, p).numpy()
    out = sharded[(k, s, p)]
    assert out.shape == jax_ref.shape == port_ref.shape
    np.testing.assert_allclose(out, jax_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, port_ref, rtol=0, atol=1e-5)


def test_one_rank_is_the_global_conv():
    """With no group the halo rows are the zero padding: the global conv."""
    x, w = inputs(4)
    got = make_spatial_conv(data_mesh(None), 2, 1)(torch.from_numpy(x), kernel_from_hwio(w))
    np.testing.assert_allclose(got.numpy(), conv2d(torch.from_numpy(x), kernel_from_hwio(w), 2, 1).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,s,p", [(5, 2, 1), (4, 1, 1)])
def test_untileable_conv_rejected(k, s, p):
    with pytest.raises(ValueError, match="does not tile evenly"):
        make_spatial_conv(data_mesh(None), stride=s, padding=p, kernel=k)
