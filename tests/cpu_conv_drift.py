"""Float32 convolution error on the CPU against float64, by layout: the
port's ``ops.conv.conv2d`` (an NHWC tensor handed to PyTorch as its
channels-last NCHW view, the layout cuDNN takes without copies), PyTorch on
a contiguous NCHW copy, and the JAX package's ``conv2d`` (XLA). One k5/s2/p1
convolution of the AudioMNIST trunk's shapes at batch 8, weights N(0, 0.01),
inputs N(0, 1); prints each relative error by the reduction length K.

    python tests/cpu_conv_drift.py
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(63, 64, 128), (15, 256, 512), (7, 512, 1024)]  # (input side, in channels, out channels)


def main() -> int:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch.nn.functional as F

    from imagecfgen_tpu.ops import conv as jconv
    from imagecfgen_torch.ops.conv import conv2d

    rng = np.random.default_rng(0)
    for h, ci, co in SHAPES:
        x = rng.normal(size=(8, h, h, ci)).astype(np.float32)
        w = (rng.normal(size=(co, ci, 5, 5)) * 0.01).astype(np.float32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        want = conv2d(xt.double(), wt.double(), 2, 1)
        got = {"port": conv2d(xt, wt, 2, 1),
               "nchw": F.conv2d(xt.permute(0, 3, 1, 2).contiguous(), wt, stride=2, padding=1).permute(0, 2, 3, 1),
               "jax": np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), 2, 1))}
        rel = {k: float((torch.as_tensor(np.asarray(v)).double() - want).norm() / want.norm()) for k, v in got.items()}
        print(f"K={25 * ci}: " + " ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
