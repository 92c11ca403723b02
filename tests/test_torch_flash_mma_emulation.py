"""The bf16 tensor-core attention kernels (``csrc/flash_attention_mma.cu``)
run on the CPU, against their plain versions.

No CUDA compiler or card is needed: the kernel source is compiled with g++
against ``tests/cuda_host_emulation/`` (a fiber per CUDA thread, lane-exact
emulations of ``ldmatrix``, ``mma.sync``, ``cp.async`` and the shuffles in
place of ``csrc/ptx_sm90.cuh``) and its launchers are called through ctypes on
CPU tensors. That holds what is easiest to get silently wrong in such a
kernel, and what the card-only tests would otherwise be the first to see: the
fragment layouts, the accumulator-to-operand repacking, the transposed
indexing of the dk/dv pass, the swizzle, the masks and tails, the cp.async
group counts and the barriers. It cannot see what only nvcc and the card
decide: PTX syntax, registers, speed.

Tolerances are the card's for bf16 (``tests/test_torch_kernels_cuda.py``): output 2e-2 absolute
and relative, gradients 2e-2 of the reference's largest magnitude, since the
kernels round P and dS to bf16 as operands and sum in another order.
"""

import ctypes
import platform
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)
from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC
from tests.cuda_host_emulation.schedules import both_schedules

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation"
H = 2  # heads: a (B, L) key mask serves H consecutive rows


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``flash_attention_mma.cu`` as a host shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    if platform.machine() != "x86_64":
        pytest.skip("the host emulation switches fibers in x86-64 assembly")
    work = tmp_path_factory.mktemp("flash_mma_emulation")
    for name in ("kernels.h", "mma_tile.cuh"):
        shutil.copy(CSRC / name, work / name)
    src = (CSRC / "flash_attention_mma.cu").read_text()
    src, n_shared = re.subn(r"extern __shared__ uint4 (\w+)\[\];",
                            r"uint4* \1 = (uint4*)emulation::shared_memory();", src)
    src, n_launch = re.subn(r"(\w+<[^;<>]*>)<<<(\w+), (\w+), (\w+), \w+>>>\(([^;]*?)\);",
                            r"emulation::launch(\2, \3, \4, [=] { \1(\5); });", src,
                            flags=re.S)
    assert (n_shared, n_launch) == (3, 3), "the kernel source no longer matches the rewrite"
    (work / "flash_attention_mma.cpp").write_text(src)
    out = work / "libflash_attention_mma.so"
    # -I before the copy's own directory is what puts the emulated
    # ptx_sm90.cuh, cuda_runtime.h and cuda_bf16.h in the real ones' place
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", f"-I{EMULATION}",
         "-o", str(out), str(work / "flash_attention_mma.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(out))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    tail = [i] * 4 + [ctypes.c_bool, ctypes.c_float, i, i64, i64, i64, p]
    cdll.flash_attention_mma_fwd_launch.argtypes = [p] * 6 + tail
    cdll.flash_attention_mma_bwd_launch.argtypes = [p] * 11 + tail
    return cdll


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(lib, rows, l, d, causal, mask_kind, strided, seed):
    """Kernel and plain (o, lse, dq, dk, dv) as contiguous (rows, L, D) rows,
    and the key mask. ``strided`` stores the tensors as (B, L, H, D)."""
    g = torch.Generator().manual_seed(seed)
    shape = (rows // H, l, H, d) if strided else (rows, l, d)
    store = [torch.randn(shape, generator=g).bfloat16() for _ in range(4)]
    layout = (H, l * H * d, d, H * d) if strided else (1, l * d, 0, d)

    def as_rows(x):
        return x.permute(0, 2, 1, 3).reshape(rows, l, d) if strided else x

    def as_stored(x):
        return x.view(rows // H, H, l, d).permute(0, 2, 1, 3).contiguous() if strided else x

    mask = None
    if mask_kind == "random":
        mask = torch.rand(rows // H, l, generator=g) < 0.7
        mask[:, 0] = True
    elif mask_kind == "prefix":
        lens = torch.randint(1, l + 1, (rows // H,), generator=g)
        mask = torch.arange(l)[None, :] < lens[:, None]
    if mask is not None:
        mask[1] = False  # batch entry 1: every key masked
    q, k, v, do = (as_rows(x) for x in store)
    scale = d ** -0.5
    ro, rlse = flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=scale)
    refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, causal=causal, scale=scale)

    m8 = None if mask is None else mask.to(torch.uint8)
    common = (rows, l, d, 1 if mask is None else H, causal, scale, *layout, None)

    def launch():
        nan = float("nan")
        o, dq, dk, dv = (torch.full(shape, nan).bfloat16() for _ in range(4))
        lse, delta = torch.full((rows, l), nan), torch.full((rows, l), nan)
        assert lib.flash_attention_mma_fwd_launch(
            *map(_ptr, (store[0], store[1], store[2], m8, o, lse)), *common) == 0
        # K3 takes the plain forward's o and lse, as the card tests feed it
        assert lib.flash_attention_mma_bwd_launch(
            *map(_ptr, (store[0], store[1], store[2], as_stored(ro), store[3], rlse, m8,
                        delta, dq, dk, dv)), *common) == 0
        return o, lse, dq, dk, dv, delta

    o, lse, dq, dk, dv, delta = both_schedules(lib, launch)
    delta_ref = (do.float() * ro.float()).sum(-1)
    return ((as_rows(o), lse, as_rows(dq), as_rows(dk), as_rows(dv), delta),
            (ro, rlse, *refs, delta_ref), mask)


@pytest.mark.parametrize("rows,l,d,causal,mask_kind,strided", [
    (4, 200, 64, False, "random", False),   # ragged tail, any key mask, a dead entry
    (2, 255, 64, True, None, False),        # the decoder's causal self-attention
    (4, 130, 128, True, "random", False),   # D = 128, causal and masked
    (4, 193, 64, False, "prefix", False),   # length masks: wholly masked key tiles
    (4, 65, 128, False, "prefix", False),   # a tail tile of one row
    (4, 130, 64, True, "random", True),     # (B, L, H, D) storage through the strides
    (4, 200, 48, False, "random", False),   # D = 48: 6 chunks in 8-chunk swizzled rows
    (4, 193, 48, False, "prefix", False),   # D = 48, length masks and a ragged tail
    (4, 130, 48, True, "random", True),     # D = 48, causal and masked, strided
    (4, 65, 96, False, "random", False),    # D = 96: 12 chunks in 16-chunk swizzled rows
])
def test_emulated_kernels_match_plain(lib, rows, l, d, causal, mask_kind, strided):
    got, want, mask = _run(lib, rows, l, d, causal, mask_kind, strided, seed=l + d)
    (o, lse, dq, dk, dv, delta), (ro, rlse, rdq, rdk, rdv, rdelta) = got, want
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse)) and not torch.isnan(lse).any()
    fin = torch.isfinite(rlse)
    torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(delta, rdelta, atol=1e-4, rtol=1e-4)
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert not torch.isnan(a.float()).any(), name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= 2e-2, (name, err)
    if mask is not None:
        dead = slice(H, 2 * H)
        assert bool(torch.isinf(lse[dead]).all())
        assert max(float(x[dead].float().abs().max()) for x in (o, dq, dk, dv)) == 0.0


def test_emulated_kernels_are_deterministic(lib):
    first = _run(lib, 4, 130, 64, True, "random", False, seed=3)[0]
    second = _run(lib, 4, 130, 64, True, "random", False, seed=3)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
