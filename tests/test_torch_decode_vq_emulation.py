"""The decode-attention (K1, ``csrc/decode_attention.cu``) and VQ argmin (K4,
``csrc/vq_argmin.cu``) kernels run on the CPU, against their plain versions.

No CUDA compiler or card is needed: both sources are compiled with g++
against ``tests/cuda_host_emulation/`` (a fiber per CUDA thread, blocks one
after another, lane-exact emulations of the shuffles, ``cp.async``,
``ldmatrix`` and ``mma.sync``, and the atomics and fences of a combine across
blocks) and their launchers are called through ctypes on CPU tensors. Since
blocks run in order, the last block of a cache row to arrive is its last
split, so the in-launch combine of the key splits runs too. What only nvcc
and the card decide (PTX syntax, registers, races between blocks, speed) is
``tests/test_torch_kernels_cuda.py``'s to see.

Tolerances are the card's: K1 fp32 1e-5 and bf16 2e-2 absolute; K4 exact
indices on inputs with a margin.
"""

import ctypes
import os
import platform
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC
from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention_plain
from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code_plain
from tests.cuda_host_emulation.schedules import both_schedules

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation"
SOURCES = {"decode_attention.cu": 2, "vq_argmin.cu": 1}  # source: its launches
L = 48


def _rewrite(src: str, n_launch: int) -> str:
    src, n_shared = re.subn(r"extern __shared__ uint4 (\w+)\[\];",
                            r"uint4* \1 = (uint4*)emulation::shared_memory();", src)
    src, n = re.subn(r"(\w+(?:<[^;<>]*>)?)<<<(\w+), (\w+), (\w+), \w+>>>\(([^;]*?)\);",
                     r"emulation::launch(\2, \3, \4, [=] { \1(\5); });", src, flags=re.S)
    assert (n_shared, n) == (n_launch, n_launch), "the kernel source no longer matches the rewrite"
    return src


def _build(work, mutate=lambda name, src: src):
    """Both sources, each rewritten for the emulation and then passed through
    ``mutate(name, source)``, as one host shared library in ``work``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    if platform.machine() != "x86_64":
        pytest.skip("the host emulation switches fibers in x86-64 assembly")
    for name in ("kernels.h", "mma_tile.cuh", "tile_io.cuh"):
        shutil.copy(CSRC / name, work / name)
    cpps = []
    for name, n_launch in SOURCES.items():
        cpp = work / name.replace(".cu", ".cpp")
        cpp.write_text(mutate(name, _rewrite((CSRC / name).read_text(), n_launch)))
        cpps.append(str(cpp))
    out = work / "libdecode_vq.so"
    # -I before the copies' own directory puts the emulated ptx_sm90.cuh,
    # cuda_runtime.h and cuda_bf16.h in the real ones' place
    build = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                            f"-I{EMULATION}", "-o", str(out), *cpps],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    return out


def _load(path):
    cdll = ctypes.CDLL(str(path))
    p, i, b = ctypes.c_void_p, ctypes.c_int, ctypes.c_bool
    cdll.decode_attention_scratch.argtypes = [i] * 5 + [b, b, p, p]
    cdll.decode_attention_launch.argtypes = ([p] * 5 + [i] + [p] * 3 + [i] * 5
                                             + [ctypes.c_float, b, p])
    cdll.vq_argmin_launch.argtypes = [p] * 3 + [i] * 3 + [p]
    return cdll


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Both sources as one host shared library."""
    return _load(_build(tmp_path_factory.mktemp("decode_vq_emulation")))


def _decode(lib, q, k, v, t, mask, scale, on_device):
    """The K1 launcher on CPU tensors; t on the 'device' passes a pointer."""
    rows, nq, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    t_val = L - 1 if t is None else t
    n_part, n_count = ctypes.c_int64(), ctypes.c_int64()
    lib.decode_attention_scratch(rows, nq, k.shape[1], d, t_val, on_device, bf16,
                                 ctypes.byref(n_part), ctypes.byref(n_count))
    t_dev = torch.tensor([t_val], dtype=torch.int32)
    m8 = None if mask is None else mask.to(torch.uint8).contiguous()

    def launch():
        part = torch.full((n_part.value,), float("nan"))
        count = torch.zeros(n_count.value, dtype=torch.int32)
        out = torch.full_like(q, float("nan"))
        assert lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if m8 is None else m8.data_ptr(),
            t_dev.data_ptr() if on_device else None, t_val, out.data_ptr(),
            part.data_ptr() if n_part.value else None,
            count.data_ptr() if n_count.value else None, rows, nq, k.shape[1], d,
            1 if mask is None else rows // mask.shape[0], scale, bf16, None) == 0
        assert not count.any(), "the last block leaves the arrival counters at zero"
        return out, count

    return both_schedules(lib, launch)[0], n_count.value > 0


def _inputs(rows, nq, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, nq, d, generator=g).to(dtype),
            torch.randn(rows, L, d, generator=g).to(dtype),
            torch.randn(rows, L, d, generator=g).to(dtype))


def _boundary(nq, dtype, d):
    """A t whose key t is the first of a split when t is read on the device
    (chunks of 16 keys for the mma kernel and fp32 at D = 64, 32 for bf16)."""
    return 32 if (dtype == torch.bfloat16 and nq < 8 and d == 64) else 16


CASES = [  # (nq, dtype, d): self, GQA, cross best-of-10, MQA cross, D = 128
    (1, torch.float32, 64), (1, torch.bfloat16, 64), (4, torch.float32, 64),
    (4, torch.bfloat16, 64), (10, torch.float32, 64), (10, torch.bfloat16, 64),
    (120, torch.bfloat16, 64), (120, torch.float32, 64), (10, torch.bfloat16, 128),
    (3, torch.float32, 128),
]


@pytest.mark.parametrize("nq,dtype,d", CASES,
                         ids=[f"nq{n}-{str(t)[6:]}-d{d}" for n, t, d in CASES])
def test_emulated_decode_attention_matches_plain(lib, nq, dtype, d):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    b = _boundary(nq, dtype, d)
    # NQ = 120 (30 fp32 query tiles a row) keeps to the boundary: the
    # emulation runs a block's 128 threads as threads of the host
    rows, ts = (1, (b,)) if nq > 10 else (2, (0, b, L - 1))
    q, k, v = _inputs(rows, nq, d, dtype, seed=nq + d)
    split_seen = False
    for t in ts:
        want = decode_attention_plain(q, k, v, t, scale=d ** -0.5)
        for on_device in (False, True):
            got, split = _decode(lib, q, k, v, t, None, d ** -0.5, on_device)
            split_seen |= split
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                                       msg=lambda m: f"t={t} on_device={on_device}: {m}")
    assert split_seen
    if nq > 10 and dtype == torch.float32:
        return
    # a key mask of two rows, each shared by m cache rows, the second fully
    # masked: exactly 0 there
    m = 1 if nq > 10 else 2
    q, k, v = _inputs(2 * m, nq, d, dtype, seed=nq + d + 1)
    mask = torch.rand(2, L, generator=torch.Generator().manual_seed(1)) < 0.6
    mask[1] = False
    want = decode_attention_plain(q, k, v, None, mask, scale=d ** -0.5)
    got, _ = _decode(lib, q, k, v, None, mask, d ** -0.5, False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert float(got[m:].float().abs().max()) == 0.0 and float(got[:m].abs().max()) > 0


def test_emulated_decode_attention_is_deterministic(lib):
    q, k, v = _inputs(2, 10, 64, torch.bfloat16, seed=5)
    mask = torch.rand(1, L, generator=torch.Generator().manual_seed(2)) < 0.7
    first, split = _decode(lib, q, k, v, None, mask, 0.125, False)
    second, _ = _decode(lib, q, k, v, None, mask, 0.125, False)
    assert split and torch.equal(first, second)


def _nearest(lib, z, e):
    def launch():
        keys = torch.full((z.shape[0],), -1, dtype=torch.int64)
        assert lib.vq_argmin_launch(z.data_ptr(), e.data_ptr(), keys.data_ptr(), z.shape[0],
                                    e.shape[0], z.shape[1], None) == 0
        return (keys,)

    return (both_schedules(lib, launch)[0] & 0xFFFFFFFF).to(torch.int32)


@pytest.mark.parametrize("n,n_e,d", [(70, 130, 20), (64, 128, 16), (130, 300, 33)])
def test_emulated_nearest_code_matches_plain(lib, n, n_e, d):
    """Ragged N, n_e and d; inputs with a margin give exact indices."""
    g = torch.Generator().manual_seed(n + d)
    e = torch.randn(n_e, d, generator=g)
    want = torch.randint(0, n_e, (n,), generator=g)
    z = e[want] + 0.01 * torch.randn(n, d, generator=g)
    got = _nearest(lib, z, e)
    assert torch.equal(got, want.int()) and torch.equal(got, nearest_code_plain(z, e))


def test_emulated_nearest_code_orders_ties_and_nan_as_argmin(lib):
    g = torch.Generator().manual_seed(7)
    e = torch.randn(200, 24, generator=g)
    e[150] = e[9]  # equal codes in two code tiles: the lower index wins
    e[40] = e[20]  # and in one
    z = torch.stack([e[9], e[20], e[150], e[3]]).clone()
    z = torch.cat([z, torch.randn(60, 24, generator=g)])
    z[10] = float("nan")
    got = _nearest(lib, z, e)
    want = nearest_code_plain(z, e)
    assert got[:4].tolist() == [9, 20, 9, 3]
    assert int(got[10]) == 0 and torch.equal(got, want)
    e[170, 2] = float("nan")  # a NaN code wins every row, as torch.argmin orders it
    assert torch.equal(_nearest(lib, z, e), nearest_code_plain(z, e))
    assert int(_nearest(lib, z, e)[0]) == 170



# Planted faults, each seen by only one of the emulation's two schedules, the
# second: the source, a text of it and what replaces it, the launch that must
# then fail and what the emulation says. Thread 0 writes the block's turn: run last to
# first, the others read the NaN-filled turn before it, take a block of an
# early split for the last one and wait at the combine's barrier, which
# thread 0 has left. A thread copies the chunk after next into the stage the
# others still read: with the copies carried out when issued, they read it.
PLANTED = {
    "turn_read_before_written": (
        "decode_attention.cu",
        "mg.last = atomicAdd(count + rq, 1) == splits - 1;\n  __syncthreads();\n",
        "mg.last = atomicAdd(count + rq, 1) == splits - 1;\n",
        "q, k, v = t._inputs(2, 10, 64, torch.bfloat16, seed=5)\n"
        "assert t._decode(lib, q, k, v, None, None, 0.125, False)[1]",
        "a barrier that can never complete"),
    "copy_into_a_stage_still_read": (
        "vq_argmin.cu",
        "    __syncthreads();  // this stage is read before the next copy into it\n", "",
        "t.test_emulated_nearest_code_matches_plain(lib, 130, 300, 33)",
        "the emulation's schedule changes the result"),
}


@pytest.mark.parametrize("fault", list(PLANTED))
def test_emulation_catches_a_planted_fault(tmp_path, fault):
    """The launch runs in a process of its own, since the emulation may
    abort it."""
    source, text, planted, launch, says = PLANTED[fault]

    def plant(name, src):
        if name == source:
            assert src.count(text) == 1, "the kernel source no longer has the planted text"
            src = src.replace(text, planted)
        return src

    lib_path = _build(tmp_path, plant)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(here), str(here.parent)]))
    script = ("import sys\nimport torch\nimport test_torch_decode_vq_emulation as t\n"
              f"lib = t._load(sys.argv[1])\n{launch}\n")
    run = subprocess.run([sys.executable, "-c", script, str(lib_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0, f"the planted fault went unseen: {run.stdout}"
    assert says in run.stderr, run.stderr[-2000:]
