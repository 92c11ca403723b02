"""Compile the flash attention sources alone and print each kernel's
registers, spills and shared memory as ``ptxas -v`` reports them.

    python -m dyadic_interaction_modeling_tpu_torch.cli.flash_mma_resources \
        [flash_attention_mma.cu] [flash_attention.cu]

With no argument it compiles ``csrc/flash_attention_mma.cu`` (bf16);
``flash_attention.cu`` is the fp32 source (3xTF32). Both run on the tensor
cores. Each builds in seconds (no PyTorch header is involved), so this is
also the quick way to ask the compiler about an edit. Needs ``nvcc``; the
kernels' results are checked by ``tests/test_torch_kernels_cuda.py``.
Every instantiation is listed by its template arguments
(D in {48, 64, 96, 128}, causal and the forward's warps in the bf16
source).
"""

from __future__ import annotations

import re
import subprocess
import sys

from ..kernels.build import BUILD_DIR, CSRC


def resources(source: str):
    """``nvcc -Xptxas -v`` of ``csrc/<source>``: (the command, its exit code,
    its output, and (kernel, ptxas line) for each kernel's resource lines)."""
    from torch.utils.cpp_extension import CUDA_HOME

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [f"{CUDA_HOME or '/usr/local/cuda'}/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v", "-c",
           "-o", str(BUILD_DIR / source.replace(".cu", ".o")), str(CSRC / source)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    # ptxas: "Compiling entry function '<mangled>'", then its "Used N registers" lines
    name, lines = None, []
    for line in (out.stdout + out.stderr).splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        elif "spill" in line or "Used" in line:
            lines.append((name, line.split(":", 1)[-1].strip()))
    return cmd, out.returncode, out.stdout + out.stderr, lines


def main(argv=None) -> int:
    for source in (sys.argv[1:] if argv is None else argv) or ["flash_attention_mma.cu"]:
        cmd, code, output, lines = resources(source)
        print(" ".join(cmd), f"-> exit {code}")
        if code:
            print(output)
            return 1
        for name, line in lines:
            print(f"  {name}: {line}")
    return 0


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma_kernel<D=48, causal=0, NW=8>`` from the mangled name
    of an instantiation (template arguments ``Li48E``, ``Lb0E``, ``Li8E``);
    the fp32 source's ``flash_fwd_kernel<D=96, causal=0>`` likewise."""
    m = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel)I(f?)((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(3))
    named = [f"{k}={v}" for k, v in zip(("D", "causal", "NW"), args)]
    return f"{m.group(1)}<{', '.join((['float'] if m.group(2) else []) + named)}>"


if __name__ == "__main__":
    sys.exit(main())
