"""IDX (the MNIST container format) reading and writing, gzip-transparent
(a copy of ``imagecfgen_tpu/morphomnist/io.py``).

Magic ``0 0 0x08 ndim``, then the dimensions as big-endian uint32, then the
raw uint8 payload.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np


def _open(path: str, mode: str):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def save_idx(data: np.ndarray, path: str) -> None:
    data = np.asarray(data, dtype=np.uint8)
    with _open(path, "wb") as f:
        f.write(struct.pack("BBBB", 0, 0, 0x08, data.ndim))
        f.write(struct.pack(">" + "I" * data.ndim, *data.shape))
        f.write(data.tobytes())


def load_idx(path: str) -> np.ndarray:
    with _open(path, "rb") as f:
        magic = f.read(4)
        dtype_code, ndim = magic[2], magic[3]
        if dtype_code != 0x08:
            raise ValueError(f"only uint8 IDX supported, got dtype code {dtype_code:#x}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        count = int(np.prod(shape))
        return np.frombuffer(f.read(count), dtype=np.uint8).reshape(shape)
