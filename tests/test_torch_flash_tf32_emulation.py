"""The fp32 attention kernels (``csrc/flash_attention.cu``: 3xTF32 products on
the tensor cores) run on the CPU, against their plain versions.

No CUDA compiler or card is needed: the kernel source is compiled with g++
against ``tests/cuda_host_emulation/`` (a fiber per CUDA thread, lane-exact
emulations of ``cvt.rna.tf32.f32``, ``mma.sync.m16n8k8`` in TF32,
``cp.async`` and the shuffles in place of ``csrc/ptx_sm90.cuh``) and its
launchers are called through ctypes on CPU tensors. That holds the fragment
layouts, the accumulator fed as an A operand with its B rows read in the
matching order, the split of each operand into two TF32 terms, the merge of
the two halves of every streamed tile, the masks and tails, the cp.async
group counts and the barriers. It cannot see what only nvcc and the card
decide: PTX syntax, registers, speed.

Tolerances are the card's for fp32 (``tests/test_torch_kernels_cuda.py``): output 2e-5
absolute, lse 1e-4, gradients 1e-4 of the reference's largest magnitude.
Shapes are tiny (L <= 80, two key tiles): the emulation runs 256 threads a
block.
"""

import ctypes
import platform
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
    _keep,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)
from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC
from tests.cuda_host_emulation.schedules import both_schedules

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation"
H = 2  # heads: a (B, L) key mask serves H consecutive rows (mask_div = H)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``flash_attention.cu`` as a host shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    if platform.machine() != "x86_64":
        pytest.skip("the host emulation switches fibers in x86-64 assembly")
    work = tmp_path_factory.mktemp("flash_tf32_emulation")
    for name in ("kernels.h", "mma_tile.cuh"):
        shutil.copy(CSRC / name, work / name)
    src = (CSRC / "flash_attention.cu").read_text()
    src, n_shared = re.subn(r"extern __shared__ float4 (\w+)\[\];",
                            r"float4* \1 = (float4*)emulation::shared_memory();", src)
    src, n_launch = re.subn(r"(\w+<[^;<>]*>)<<<(\w+), (\w+), (\w+), \w+>>>\(([^;]*?)\);",
                            r"emulation::launch(\2, \3, \4, [=] { \1(\5); });", src,
                            flags=re.S)
    assert (n_shared, n_launch) == (3, 3), "the kernel source no longer matches the rewrite"
    (work / "flash_attention.cpp").write_text(src)
    out = work / "libflash_attention.so"
    # -I before the copy's own directory is what puts the emulated
    # ptx_sm90.cuh, cuda_runtime.h and cuda_bf16.h in the real ones' place
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", f"-I{EMULATION}",
         "-o", str(out), str(work / "flash_attention.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 4 + [ctypes.c_bool, ctypes.c_float, p]
    cdll.flash_attention_fwd_launch.argtypes = [p] * 6 + tail
    cdll.flash_attention_bwd_launch.argtypes = [p] * 11 + tail
    return cdll


def _ptr(t):
    return None if t is None else t.data_ptr()


def _inputs(rows, l, d, mask_kind, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((rows, l, d), dtype=np.float32))
                   for _ in range(4))
    mask = None
    if mask_kind == "random":
        mask = torch.from_numpy(rng.random((rows // H, l)) < 0.7)
        mask[:, 0] = True
    elif mask_kind == "prefix":
        lens = rng.integers(1, l + 1, rows // H)
        mask = torch.arange(l)[None, :] < torch.from_numpy(lens)[:, None]
    if mask is not None:
        mask[1] = False  # batch entry 1: every key masked
    return q * q_scale, k, v, do, mask


def _kernels(lib, q, k, v, do, ro, rlse, mask, causal, scale):
    """(o, lse) of K2 and (dq, dk, dv, delta) of K3, which takes the plain
    forward's o and lse, as the card tests feed it."""
    rows, l, d = q.shape
    m8 = None if mask is None else mask.to(torch.uint8)
    common = (rows, l, d, 1 if mask is None else H, causal, scale, None)

    def launch():
        nan = float("nan")
        o, dq, dk, dv = (torch.full((rows, l, d), nan) for _ in range(4))
        lse, delta = torch.full((rows, l), nan), torch.full((rows, l), nan)
        assert lib.flash_attention_fwd_launch(*map(_ptr, (q, k, v, m8, o, lse)), *common) == 0
        assert lib.flash_attention_bwd_launch(
            *map(_ptr, (q, k, v, ro, do, rlse, m8, delta, dq, dk, dv)), *common) == 0
        return o, lse, dq, dk, dv, delta

    return both_schedules(lib, launch)


def _deltas(q, k, v, do, mask, causal, scale, lse):
    """The backward's delta, sum_j p dp / sum_j p (0 for a row that attends
    nothing), as the kernel defines it: in fp32 from the plain forward's lse,
    and in fp64 from the exact softmax."""
    keep = _keep(q, mask, causal)
    out = []
    for dt in (torch.float32, torch.float64):
        s = torch.matmul(q.to(dt), k.to(dt).transpose(1, 2)) * scale
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        p = (torch.exp(s - lse[..., None]) if dt == torch.float32
             else torch.softmax(s, dim=-1).nan_to_num(0.0))
        dp = torch.matmul(do.to(dt), v.to(dt).transpose(1, 2))
        ps = p.sum(-1)
        out.append(torch.where(ps > 0, (p * dp).sum(-1) / ps.clamp_min(1e-30), 0.0))
    return out


def _run(lib, rows, l, d, causal, mask_kind, seed, q_scale=1.0):
    q, k, v, do, mask = _inputs(rows, l, d, mask_kind, seed, q_scale)
    scale = d ** -0.5
    ro, rlse = flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=scale)
    refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, causal=causal, scale=scale)
    got = _kernels(lib, q, k, v, do, ro, rlse, mask, causal, scale)
    return got, (ro, rlse, *refs, _deltas(q, k, v, do, mask, causal, scale, rlse)), mask


def _assert_close(got, want):
    """delta (sum p dp / sum p, the dq pass's first sweep) is held against
    its fp64 value: within 1e-5, or within 4x the error of the same
    definition in plain fp32 (where the scores are large, 3xTF32 products
    round them a few times coarser than fp32's)."""
    (o, lse, dq, dk, dv, delta), (ro, rlse, rdq, rdk, rdv, (d32, d64)) = got, want
    assert float((o - ro).abs().max()) <= 2e-5
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse)) and not torch.isnan(lse).any()
    fin = torch.isfinite(rlse)
    assert float((lse[fin] - rlse[fin]).abs().max()) <= 1e-4
    err, err32 = (float((x.double() - d64).abs().max()) for x in (delta, d32))
    assert err <= max(1e-5, 4 * err32), (err, err32)
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert not torch.isnan(a).any(), name
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("rows,l,d,causal,mask_kind", [
    (4, 80, 48, False, "random"),   # D = 48, a ragged tail, any key mask, a dead entry
    (4, 80, 64, True, "random"),    # causal and masked: diagonal and tail tiles at once
    (2, 70, 96, False, None),       # D = 96 unmasked, as the speaker VQ runs it
    (4, 66, 128, True, "prefix"),   # D = 128, length masks, a tail of two rows
])
def test_emulated_kernels_match_plain(lib, rows, l, d, causal, mask_kind):
    got, want, mask = _run(lib, rows, l, d, causal, mask_kind, seed=l + d)
    _assert_close(got, want)
    if mask is not None:
        o, lse, dq, dk, dv, _ = got
        dead = slice(H, 2 * H)
        assert bool(torch.isinf(lse[dead]).all())
        assert max(float(x[dead].abs().max()) for x in (o, dq, dk, dv)) == 0.0


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def test_three_tf32_terms_keep_fp32_agreement_where_one_does_not(lib):
    """Scores up to ~±30: one TF32 pass (the plain version on TF32-rounded
    operands) misses the output tolerance; the kernels' three terms keep it."""
    rows, l, d = 2, 64, 64
    q, k, v, do, _ = _inputs(rows, l, d, None, seed=5)
    scale = d ** -0.5
    q = q * (30.0 / float((q @ k.transpose(1, 2) * scale).abs().max()))
    s = (q @ k.transpose(1, 2) * scale).abs().max()
    assert 29.0 <= float(s) <= 31.0
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal=False, scale=scale)
    refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, causal=False, scale=scale)
    got = _kernels(lib, q, k, v, do, ro, rlse, None, False, scale)
    _assert_close(got, (ro, rlse, *refs, _deltas(q, k, v, do, None, False, scale, rlse)))
    one_pass, _ = flash_attention_fwd_plain(_tf32(q), _tf32(k), _tf32(v), causal=False,
                                            scale=scale)
    assert float((one_pass - ro).abs().max()) > 2e-5


def test_emulated_kernels_are_deterministic(lib):
    first = _run(lib, 4, 80, 64, True, "random", seed=3)[0]
    second = _run(lib, 4, 80, 64, True, "random", seed=3)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
