"""Checkpoints: the port's own training states, and a reader for the files the
JAX package writes (port of ``imagecfgen_tpu/core/checkpoint.py``).

Both kinds of file share one layout: four magic bytes, ``<II`` version and
meta length, a JSON meta header, then the payload. ``load_meta`` reads the
header of either without touching the payload.

- The port's files (magic ``ICFP``) carry a ``torch.save`` payload: the
  nested dict a trainer's ``state_dict()`` returns (parameters, buffers, both
  Adam states, the step, the generator's state). They are written atomically
  and read back with ``weights_only=True``; a run that is saved and resumed
  on the same device continues bit for bit.
- The JAX package's files (magic ``ICFT``) carry a flax msgpack payload:
  plain msgpack maps, ext type 1 for an ndarray and ext type 3 for a numpy
  scalar (both a packed ``(shape, dtype name, bytes)`` triple), tuples as
  ``{"0": ..., "1": ...}`` maps, and arrays over 2**30 bytes as a
  ``__msgpack_chunked_array__`` map of ``shape`` and ``chunks``. The machine
  with the card has no ``msgpack`` package, so :func:`unpack_msgpack` is a
  small decoder of its own. ``load_checkpoint`` returns trees of numpy
  arrays, which ``core.convert`` carries into the port's modules.
"""
from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

JAX_MAGIC = b"ICFT"    # what imagecfgen_tpu.core.checkpoint writes
TORCH_MAGIC = b"ICFP"  # the port's own training states
_VERSION = 1
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _read_meta(f, path: str, magics: Tuple[bytes, ...]) -> Dict:
    """Check the magic and read the meta; leaves ``f`` at the payload."""
    magic = f.read(4)
    if magic not in magics:
        raise ValueError(f"{path}: not an imagecfgen checkpoint of the expected kind "
                         f"(magic {magic!r}, expected one of {magics})")
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{path}: truncated header")
    _version, meta_len = struct.unpack("<II", head)
    meta = f.read(meta_len)
    if len(meta) != meta_len:
        raise ValueError(f"{path}: truncated meta")
    return json.loads(meta.decode("utf-8"))


def checkpoint_format(path: str) -> str:
    """``"torch"`` for a file of :func:`save_train_state`, ``"jax"`` for one
    the JAX package wrote, read from the magic (both kinds share the artifact
    names); anything else raises, naming both magics."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == TORCH_MAGIC:
        return "torch"
    if magic == JAX_MAGIC:
        return "jax"
    raise ValueError(f"{path}: neither a port checkpoint (magic {TORCH_MAGIC!r}) nor one of the "
                     f"JAX package (magic {JAX_MAGIC!r}); it starts with {magic!r}")


def load_meta(path: str) -> Dict:
    """Only the JSON meta header of a checkpoint of either kind."""
    with open(path, "rb") as f:
        return _read_meta(f, path, (JAX_MAGIC, TORCH_MAGIC))


# ------------------------------------------------------------ the port's files


def save_train_state(path: str, state: Dict, meta: Optional[Dict] = None) -> None:
    """Atomically write a trainer's ``state_dict()`` and a JSON meta."""
    meta_bytes = json.dumps(meta or {}).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(TORCH_MAGIC)
        f.write(struct.pack("<II", _VERSION, len(meta_bytes)))
        f.write(meta_bytes)
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_train_state(path: str, device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """``(state, meta)`` of a file from :func:`save_train_state`, its tensors
    on ``device`` (the card unless asked otherwise); hand ``state`` to the
    trainer's ``load_state_dict``."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        meta = _read_meta(f, path, (TORCH_MAGIC,))
        # read in place: an ESRF training state is gigabytes, and a copy of
        # the payload in host memory would hold it twice while it loads
        state = torch.load(_Payload(f, f.tell()), map_location=device, weights_only=True)
    return state, meta


class _Payload(io.RawIOBase):
    """The file from ``offset`` on, as a file of its own: the archive that
    ``torch.load`` reads counts its offsets from its own first byte."""

    def __init__(self, f, offset: int):
        super().__init__()
        self._f, self._offset = f, offset

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._f.tell() - self._offset

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        self._f.seek(self._offset + pos if whence == io.SEEK_SET else pos, whence)
        return self.tell()

    def readinto(self, buf) -> int:
        return self._f.readinto(buf)


# ------------------------------------------------- the JAX package's files


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("msgpack payload ends inside a value")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(body: memoryview) -> np.ndarray:
    """An ext body: msgpack of ``(shape, dtype name, bytes)``."""
    shape, name, buf = _unpack(_Reader(body), raw=True)
    name = bytes(name).decode("ascii")
    if name == "bfloat16":  # numpy has no such type: the upper half of a float32
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    # a copy: writable, and it lets go of the file's bytes
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unpack(r: _Reader, raw: bool = False) -> Any:
    """One msgpack value. ``raw``: leave ``str`` values as bytes (the inner
    encoding of an ndarray is read so)."""
    b = r.number("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return r.take(r.number({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b]))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.number({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
        return _ext(r.number("b"), r.take(n))
    if b == 0xCA:
        return r.number(">f")
    if b == 0xCB:
        return r.number(">d")
    if 0xCC <= b <= 0xCF:
        return r.number((">B", ">H", ">I", ">Q")[b - 0xCC])
    if 0xD0 <= b <= 0xD3:
        return r.number((">b", ">h", ">i", ">q")[b - 0xD0])
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.number("b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return _str(r, r.number({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
    if b in (0xDC, 0xDD):
        return [_unpack(r, raw) for _ in range(r.number(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _map(r, r.number(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"msgpack type byte {b:#x} is not supported")


def _str(r: _Reader, n: int, raw: bool):
    data = r.take(n)
    return data if raw else bytes(data).decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> Dict:
    out = {}
    for _ in range(n):
        key = _unpack(r, raw)
        out[bytes(key) if isinstance(key, memoryview) else key] = _unpack(r, raw)
    return out


def _ext(code: int, body: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(body)
    if code == _EXT_NPSCALAR:
        return _ndarray(body)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")


def _unchunk(tree):
    """Reassemble ``__msgpack_chunked_array__`` maps (flax splits arrays
    over 2**30 bytes into flat chunks)."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpack_msgpack(payload: bytes):
    """A flax msgpack payload -> nested dicts with numpy leaves (what
    ``flax.serialization.msgpack_restore`` returns)."""
    r = _Reader(payload)
    tree = _unpack(r)
    if r.at != len(r.data):
        raise ValueError(f"{len(r.data) - r.at} bytes after the msgpack value")
    return _unchunk(tree)


def restore_sequences(x):
    """flax encodes tuples and lists as ``{"0": ..., "1": ...}`` maps; turn
    those back into tuples (flow-chain params and state, MLP layer lists and
    optax states are positional)."""
    if isinstance(x, dict):
        keys = list(x.keys())
        if keys and all(isinstance(k, str) and k.isdigit() for k in keys):
            return tuple(restore_sequences(x[str(i)]) for i in range(len(keys)))
        return {k: restore_sequences(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(restore_sequences(v) for v in x)
    return x


def load_checkpoint(path: str) -> Tuple[Any, Dict]:
    """``(tree, meta)`` of a file that the JAX package's ``save_checkpoint``
    wrote: the raw nested structure with numpy leaves, tuples restored
    (bfloat16 leaves as their exact float32 values: numpy has no such type)."""
    with open(path, "rb") as f:
        meta = _read_meta(f, path, (JAX_MAGIC,))
        payload = f.read()
    return restore_sequences(unpack_msgpack(payload)), meta
