"""PyTorch/CUDA port of ``imagecfgen_tpu`` for NVIDIA Hopper GPUs.

The module layout mirrors ``imagecfgen_tpu`` so each port module sits at the
same path as its counterpart. Public layouts match the JAX package: images
are NHWC in [-1, 1], attribute dicts hold one-hot categoricals and ``(B,)``
continuous values, and latents are ``(B, 1, 1, latent)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise (see :mod:`.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
