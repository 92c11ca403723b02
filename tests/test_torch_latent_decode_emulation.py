"""The latent decode attention kernel (K5, ``csrc/latent_decode.cu``) runs on
the CPU against its plain version.

As ``test_torch_decode_vq_emulation.py`` does for K1 and K4: the source is
compiled with g++ against ``tests/cuda_host_emulation/`` (a fiber per CUDA
thread, lane-exact ``cp.async``, ``ldmatrix`` and ``mma.sync``) and its
launcher is called through ctypes on CPU tensors, under both of the
emulation's schedules. What only nvcc and the card decide (PTX syntax,
registers, speed) is ``tests/test_torch_kernels_cuda.py``'s to see.

The tolerance is the card's: bf16 outputs within 2e-2 of the plain version
(P is rounded to bf16 as the tensor cores' operand, the output to bf16).
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC
from dyadic_interaction_modeling_tpu_torch.kernels.latent_decode import (
    DK, HEADS, latent_decode_plain)
from tests.cuda_host_emulation.schedules import both_schedules

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation"

L = 150  # three 64-key tiles, the last ragged


def _rewrite(src: str) -> str:
    """The kernel's shared memory and its two launches (the key splits, then
    their combine) in the emulation's terms."""
    src, n_shared = re.subn(r"extern __shared__ uint4 (\w+)\[\];",
                            r"uint4* \1 = (uint4*)emulation::shared_memory();", src)
    src, n = re.subn(r"(\w+)<<<(\w+), (\w+), (\w+), \w+>>>\(([^;]*?)\);",
                     r"emulation::launch(\2, \3, \4, [=] { \1(\5); });", src, flags=re.S)
    assert (n_shared, n) == (1, 2), "the kernel source no longer matches the rewrite"
    return src


def _build(work):
    import platform
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    if platform.machine() != "x86_64":
        pytest.skip("the host emulation switches fibers in x86-64 assembly")
    for name in ("kernels.h", "mma_tile.cuh", "tile_io.cuh"):
        shutil.copy(CSRC / name, work / name)
    cpp = work / "latent_decode.cpp"
    cpp.write_text(_rewrite((CSRC / "latent_decode.cu").read_text()))
    out = work / "liblatent.so"
    build = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                            f"-I{EMULATION}", "-o", str(out), str(cpp)],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(out))
    p, i, b = ctypes.c_void_p, ctypes.c_int, ctypes.c_bool
    cdll.latent_decode_scratch.argtypes = [i, i, i, b, p]
    cdll.latent_decode_launch.argtypes = [p, p, p, i, p, p, i, i, ctypes.c_float, p]
    return cdll


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("latent_emulation"))


def _launch(lib, q, cache, t, scale, on_device):
    rows = q.shape[0]
    n_part = ctypes.c_int64()
    lib.latent_decode_scratch(rows, cache.shape[1], t, on_device, ctypes.byref(n_part))
    t_dev = torch.tensor([t], dtype=torch.int32)

    def launch():
        part = torch.full((n_part.value,), float("nan"))
        out = torch.full((rows, HEADS, 512), float("nan")).to(torch.bfloat16)
        assert lib.latent_decode_launch(
            q.data_ptr(), cache.data_ptr(), t_dev.data_ptr() if on_device else None, t,
            out.data_ptr(), part.data_ptr() if n_part.value else None, rows, cache.shape[1],
            scale, None) == 0
        return (out,)

    return both_schedules(lib, launch)[0], n_part.value > 0


@pytest.mark.parametrize("rows,ts", [(1, (0, 63, 64, 149)), (2, (100,))])
def test_emulated_latent_decode_matches_plain(lib, rows, ts):
    """One row splits its keys over 64-key chunks (the t = 64 chunk starts a
    split on the device's position); t on the host and on the device."""
    g = torch.Generator().manual_seed(rows)
    q = torch.randn(rows, HEADS, DK, generator=g).to(torch.bfloat16)
    cache = torch.randn(rows, L, DK, generator=g).to(torch.bfloat16)
    scale = 192 ** -0.5 * 1.5897
    split_seen = False
    for t in ts:
        want = latent_decode_plain(q, cache, t, scale=scale)
        for on_device in (False, True):
            got, split = _launch(lib, q, cache, t, scale, on_device)
            split_seen |= split
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0,
                                       msg=lambda m: f"t={t} on_device={on_device}: {m}")
    assert split_seen
