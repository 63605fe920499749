"""Morpho-MNIST dataset loading (a copy of ``imagecfgen_tpu/data/mnist.py``).

A dataset directory holds ``mnist-x-{split}.npy`` (images ``(N, 28, 28)`` in
[0, 255]) and ``mnist-a-{split}.npy`` (the 13-column attribute layout
``[one-hot digit (10), thickness, intensity, slant]``). Both loaders return
numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..core.attributes import MNIST_LAYOUT, split_columns


def load_mnist_arrays(data_dir: str, split: str = "train") -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Returns (x (N,28,28) float32 in [0,255], attrs dict)."""
    x = np.load(os.path.join(data_dir, f"mnist-x-{split}.npy")).astype(np.float32)
    a = np.load(os.path.join(data_dir, f"mnist-a-{split}.npy")).astype(np.float32)
    attrs = split_columns(a, None, MNIST_LAYOUT)
    return x, attrs


def load_raw_mnist(raw_dir: str, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """Read original MNIST IDX files (images, labels) from a directory
    containing e.g. ``train-images-idx3-ubyte.gz``."""
    prefix = "train" if split == "train" else "t10k"
    img_path = None
    lbl_path = None
    for suffix in ("", ".gz"):
        p = os.path.join(raw_dir, f"{prefix}-images-idx3-ubyte{suffix}")
        if os.path.exists(p):
            img_path = p
        p = os.path.join(raw_dir, f"{prefix}-labels-idx1-ubyte{suffix}")
        if os.path.exists(p):
            lbl_path = p
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(f"MNIST IDX files not found under {raw_dir}")
    from ..morphomnist.io import load_idx

    return load_idx(img_path), load_idx(lbl_path)
