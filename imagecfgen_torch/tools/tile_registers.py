"""Registers and spills of the wgmma kernel's 256 x 128 tile (512 threads, at
most 128 registers a thread) with and without the promoted float32 sum, in
both types: the reason ``ops/tensor_core.py`` keeps float32 layers off that
tile (``UNPROMOTED_TILES``).

    python imagecfgen_torch/tools/tile_registers.py

Compiles ``csrc/tc_gemm.cuh`` with explicit instantiations of
``conv_wgmma<T, 256, 128, PROMOTE>`` for T in (float, bf16) and PROMOTE in
(false, true) by ``nvcc -Xptxas -v`` (the flags of ``ops/_build.py``, into a
temporary directory) and prints one line per instantiation: its mangled name
(``If``: float, ``I13__nv_bfloat16``: bf16; ``Lb1E``: the promoted sum),
registers and spill bytes; before them, any warning ptxas gives. Needs
``nvcc``, not a card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBE = """#include "{header}"
namespace tcg {{
template __global__ void conv_wgmma<float, 256, 128, false>(const ConvArgs);
template __global__ void conv_wgmma<float, 256, 128, true>(const ConvArgs);
template __global__ void conv_wgmma<__nv_bfloat16, 256, 128, false>(const ConvArgs);
template __global__ void conv_wgmma<__nv_bfloat16, 256, 128, true>(const ConvArgs);
}}
"""


def main() -> int:
    sys.path.insert(0, HERE)
    from imagecfgen_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE.format(header=CSRC_DIR / "tc_gemm.cuh"))
        out = subprocess.run([_nvcc(), *flags, "-c", "-o", os.path.join(tmp, "probe.o"), src],
                             capture_output=True, text=True, timeout=600)
    log = out.stdout + out.stderr
    if out.returncode != 0:
        print(log, file=sys.stderr)
        return out.returncode
    for line in log.splitlines():  # what ptxas warns of (a serialised wgmma, say)
        if "warning" in line.lower() or "performance" in line.lower():
            print(line)
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]  # mangled: ...conv_wgmmaI<type>Li256ELi128ELb<0|1>E...
        used = re.search(r"Used (\d+) registers", chunk)
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        print(f"{name}: {used.group(1) if used else '?'} registers, {stores.group(1) if stores else '?'} bytes "
              f"spill stores, {stores.group(2) if stores else '?'} bytes spill loads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
