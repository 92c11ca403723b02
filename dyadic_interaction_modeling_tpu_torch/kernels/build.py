"""Build and load the port's hand-written CUDA kernels.

The sources in ``csrc/`` are the kernels (``*.cu``, plain CUDA C++ whose
launchers ``kernels.h`` declares, with the device helpers of
``tile_io.cuh`` and ``mma_tile.cuh``) and ``binding.cpp``, the one file that
includes PyTorch's headers. One ``torch.utils.cpp_extension.load`` call
compiles them all for ``sm_90a`` (Hopper), ninja running one compiler per
source at once, at first use and never at import, into ``_build/`` beside
the package sources (git-ignored). ``load`` rebuilds only when a source or
a flag changed.
"""

from __future__ import annotations

from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("binding.cpp", "decode_attention.cu", "flash_attention.cu",
           "flash_attention_mma.cu", "vq_argmin.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_EXT = None


def extension():
    """The compiled extension module, built and loaded on the first call."""
    global _EXT
    if _EXT is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _EXT = load(name="dyadic_interaction_modeling_tpu_torch_kernels",
                    sources=[str(CSRC / s) for s in SOURCES],
                    extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS,
                    build_directory=str(BUILD_DIR), verbose=False)
    return _EXT
