"""Compile the flash attention sources alone and print each kernel's
registers, spills and shared memory as ``ptxas -v`` reports them.

    python -m dyadic_interaction_modeling_tpu_torch.cli.flash_mma_resources \
        [flash_attention_mma.cu] [flash_attention.cu]

With no argument it compiles ``csrc/flash_attention_mma.cu`` (bf16, tensor
cores); ``flash_attention.cu`` is the fp32 source. Each builds in seconds
(no PyTorch header is involved), so this is also the quick way to ask the
compiler about an edit. Needs ``nvcc``; the kernels' results are checked by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``. Every
instantiation is listed by its template arguments (D in {48, 64, 96, 128},
causal and the forward's warps in the bf16 source).
"""

from __future__ import annotations

import re
import subprocess
import sys

from ..kernels.build import BUILD_DIR, CSRC


def main(argv=None) -> int:
    from torch.utils.cpp_extension import CUDA_HOME

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for source in (sys.argv[1:] if argv is None else argv) or ["flash_attention_mma.cu"]:
        cmd = [f"{CUDA_HOME or '/usr/local/cuda'}/bin/nvcc", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v", "-c",
               "-o", str(BUILD_DIR / source.replace(".cu", ".o")), str(CSRC / source)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        print(" ".join(cmd), f"-> exit {out.returncode}")
        if out.returncode:
            print(out.stdout + out.stderr)
            return 1
        # ptxas: "Compiling entry function '<mangled>'", then its "Used N registers" lines
        name = None
        for line in (out.stdout + out.stderr).splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                name = _kernel_name(entry.group(1))
            elif "spill" in line or "Used" in line:
                print(f"  {name}: {line.split(':', 1)[-1].strip()}")
    return 0


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma_kernel<D=48, causal=0, NW=8>`` from the mangled name
    of an instantiation (template arguments ``Li48E``, ``Lb0E``, ``Li8E``);
    the fp32 source's ``flash_fwd_kernel<float, D=96>`` from ``IfLi96EE``."""
    m = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel)I(f?)((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(3))
    named = [f"{k}={v}" for k, v in zip(("D", "causal", "NW"), args)]
    return f"{m.group(1)}<{', '.join((['float'] if m.group(2) else []) + named)}>"


if __name__ == "__main__":
    sys.exit(main())
