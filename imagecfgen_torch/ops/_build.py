"""Build the port's native sources at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone (no PyTorch headers) into ``build/<name>-<hash>.so`` at the
repository root, a git-ignored directory. The hash covers the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
The ``csrc/*.cuh`` headers the sources share are part of every hash.

The host-side C++ of the morphometry oracle (``csrc/<name>.cpp``) is built
the same way by the host compiler (``$CXX``, else ``g++``):
:func:`load_host_library`. A build that fails raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``name -> (seconds, nvcc output)`` of the builds made by this process
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_libraries(*names: str) -> None:
    """Compile every missing ``csrc/<name>.cu`` of ``names`` with one
    ``nvcc`` each, all started together, then load them."""
    builds = []
    for name in names:
        out = _target(name)
        if name in _LIBS or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    if name not in _LIBS:
        load_libraries(name)
    return _LIBS[name]


def _host_target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with the host compiler (``$CXX``, else
    ``g++``) if its build is missing, then load it. A failed build raises."""
    key = f"host:{name}"
    if key not in _LIBS:
        out = _host_target(name)
        if not out.exists():
            cxx = os.environ.get("CXX", "g++")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise RuntimeError(f"{cxx} could not be run to build {name}.cpp: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {name}.cpp:\n{proc.stdout}")
            os.replace(tmp, out)
        _LIBS[key] = ctypes.CDLL(str(out))
    return _LIBS[key]
