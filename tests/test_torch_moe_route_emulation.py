"""The expert layer's routing, dispatch and combine kernels (K6,
``csrc/moe_route.cu``) run on the CPU against their plain versions
(``kernels/moe_route.py``).

As ``test_torch_latent_decode_emulation.py`` does for K5: the source is
compiled with g++ against ``tests/cuda_host_emulation/`` (a fiber per CUDA
thread, lane-exact shuffles and warp reductions; blocks in order, so the last
block to arrive is the grid's last) and its launchers are called through
ctypes on CPU tensors, under both of the emulation's schedules. What only
nvcc and the card decide (PTX, registers, races between blocks, speed) is the
``cuda`` tests' of ``tests/test_torch_deepseek_v2.py``.

The gate logits are made exact: x's first E columns hold them in bf16 and the
gate is the identity there (zero beyond), so ``router_logits`` gives them
bit for bit. The experts, their ends, the positions, ``expert_load`` and the
routed rows must be equal; the weights within 1e-6 (the emulation's ``expf``
is the C library's, the plain softmax's PyTorch's); the combine bitwise
(the same fp32 products and sums in slot order, the same roundings).
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC
from dyadic_interaction_modeling_tpu_torch.kernels.moe_route import (
    moe_combine_plain, moe_dispatch_plain, router_logits)
from tests.cuda_host_emulation.schedules import both_schedules

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation"


def _rewrite(src: str) -> str:
    """The route kernel's shared memory and the three launches in the
    emulation's terms."""
    src, n_shared = re.subn(r"extern __shared__ uint4 (\w+)\[\];",
                            r"uint4* \1 = (uint4*)emulation::shared_memory();", src)
    src, n = re.subn(r"(\w+)<<<(\w+), (\w+), (\w+), \w+>>>\(([^;]*?)\);",
                     r"emulation::launch(\2, \3, \4, [=] { \1(\5); });", src, flags=re.S)
    assert (n_shared, n) == (1, 3), "the kernel source no longer matches the rewrite"
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    import platform
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    if platform.machine() != "x86_64":
        pytest.skip("the host emulation switches fibers in x86-64 assembly")
    work = tmp_path_factory.mktemp("moe_emulation")
    shutil.copy(CSRC / "kernels.h", work / "kernels.h")
    cpp = work / "moe_route.cpp"
    cpp.write_text(_rewrite((CSRC / "moe_route.cu").read_text()))
    out = work / "libmoe.so"
    build = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                            f"-I{EMULATION}", "-o", str(out), str(cpp)],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(out))
    p, i, b, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_bool, ctypes.c_float
    cdll.moe_dispatch_scratch.argtypes = [i, i, i, p]
    cdll.moe_dispatch_scratch.restype = None
    cdll.moe_dispatch_launch.argtypes = [p, p, i, i, i, i, b, f, p, p, p, p, p, p, p, p, p]
    cdll.moe_combine_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    return cdll


def _inputs(n, e, h, seed, bias=None):
    """x (n, h) bf16 whose first e columns are the gate logits, and the gate."""
    g = torch.Generator().manual_seed(seed)
    logits = 2 * torch.randn(n, e, generator=g)
    if bias is not None:
        logits = logits + bias
    x = torch.cat([logits, torch.randn(n, h - e, generator=g)], 1).to(torch.bfloat16)
    gate = torch.cat([torch.eye(e), torch.zeros(e, h - e)], 1).to(torch.bfloat16)
    return x, gate


def _dispatch(lib, x, gate, k, norm, scaling, load0):
    n, h = x.shape
    e = gate.shape[0]
    logits = router_logits(x, gate).contiguous()
    n_scratch = ctypes.c_int64()
    lib.moe_dispatch_scratch(n, e, k, ctypes.byref(n_scratch))

    def launch():
        w = torch.full((n, k), float("nan"))
        ids, pos = (torch.full((n, k), -7, dtype=torch.int32) for _ in range(2))
        ends = torch.full((e,), -7, dtype=torch.int32)
        xs = torch.full((n * k, h), float("nan")).to(torch.bfloat16)
        load = load0.clone()
        scratch = torch.full((n_scratch.value,), -7, dtype=torch.int32)
        arrivals = torch.zeros(1, dtype=torch.int32)
        assert lib.moe_dispatch_launch(
            logits.data_ptr(), x.data_ptr(), n, e, k, h, norm, scaling, w.data_ptr(),
            ids.data_ptr(), ends.data_ptr(), pos.data_ptr(), xs.data_ptr(), load.data_ptr(),
            scratch.data_ptr(), arrivals.data_ptr(), None) == 0
        assert int(arrivals) == 0, "the launch leaves the arrival counter at zero"
        return w, ids, ends, pos, xs, load

    return both_schedules(lib, launch)


def _combine(lib, ys, w, pos, shared):
    n, k = w.shape

    def launch():
        y = torch.full((n, ys.shape[1]), float("nan")).to(torch.bfloat16)
        assert lib.moe_combine_launch(ys.data_ptr(), w.data_ptr(), pos.data_ptr(),
                                      None if shared is None else shared.data_ptr(),
                                      y.data_ptr(), n, k, ys.shape[1], None) == 0
        return (y,)

    return both_schedules(lib, launch)[0]


CASES = {
    # (n, experts, k, hidden): n not a multiple of the 8-token block, counts
    # ragged by a bias over the experts, expert 5 never chosen, tied logits
    "ragged": (100, 16, 4, 64),
    # every pair to expert 7
    "one_expert": (37, 8, 1, 16),
    # the dsv2 router's 64 experts top-6 over 4,300 tokens: two tokens a warp,
    # 269 blocks, the last block's scan in four groups
    "many_blocks": (4300, 64, 6, 72),
}


@pytest.mark.parametrize("case,norm,scaling", [("ragged", False, 1.0), ("ragged", True, 2.5),
                                               ("one_expert", False, 1.0),
                                               ("many_blocks", False, 1.0)])
def test_emulated_dispatch_and_combine_match_plain(lib, case, norm, scaling):
    n, e, k, h = CASES[case]
    x, gate = _inputs(n, e, h, seed=len(case) + 10 * norm,
                      bias=torch.linspace(-3, 3, e) if case == "ragged" else None)
    if case == "ragged":
        x[:, 5] = -30.0
        x[:3, :e] = 0.0
        x[0, 9] = x[0, 2] = 4.0  # two equal maxima: 2 before 9
        x[1, [3, 8, 11, 14, 15]] = 3.0  # five equal maxima, k 4: the lowest four
        x[2, :e] = 1.0  # all equal: experts 0..3
    if case == "one_expert":
        x[:, 7] += 30.0
    load0 = torch.arange(e, dtype=torch.int64) * 1000
    w, ids, ends, pos, xs, load = _dispatch(lib, x, gate, k, norm, scaling, load0)
    load_plain = load0.clone()
    want = moe_dispatch_plain(x, gate, k, norm, scaling, load_plain)
    for name, got, ref in zip(("ids", "ends", "pos", "xs"), (ids, ends, pos, xs), want[1:]):
        assert torch.equal(got, ref), name
    torch.testing.assert_close(w, want[0], rtol=1e-6, atol=0)
    assert torch.equal(load, load_plain)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    if case == "ragged":
        assert ids[0].tolist()[:2] == [2, 9] and ids[1].tolist() == [3, 8, 11, 14]
        assert ids[2].tolist() == [0, 1, 2, 3]
        assert int(counts[5]) == 0 and len(set(counts.tolist())) > 5
        assert n % 8
    if case == "one_expert":
        assert counts.tolist() == [0] * 7 + [n] and torch.equal(xs, x)

    g = torch.Generator().manual_seed(n)
    ys = torch.randn(n * k, h, generator=g).to(torch.bfloat16)
    shared = torch.randn(n, h, generator=g).to(torch.bfloat16)
    for sh in (shared, None):
        assert torch.equal(_combine(lib, ys, w, pos, sh), moe_combine_plain(ys, w, pos, sh))
