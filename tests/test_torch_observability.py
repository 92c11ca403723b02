"""The port's run records and small utils against the JAX package on the CPU:
``make_grid`` / ``to_uint8`` and ``MetricsWriter`` write the files JAX's
writer writes for the same calls (``scalars.jsonl``, ``hparams.json``,
``images/<tag>_<step:09d>.png``), the tensorboard mirror's calls, the LR
schedules against JAX's values and through ``LambdaLR``,
``set_random_seed``, the logger and meters, and ``trace`` with its spans.

``assert_run_record`` and ``no_tensorboard`` serve the tests that run the
four training twins: the records they must write (the tags of
``tests/test_postprocess_cli.py``'s ``_assert_observability_artifacts``),
written without the tensorboard mirror, as on a host without the
``tensorboard`` package (importing it here pulls in TensorFlow, ~15 s)."""

import json
import os
import random
import sys
import time
import types

import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.utils import observability as JO
from dyadic_interaction_modeling_tpu.utils import schedules as JS
from dyadic_interaction_modeling_tpu_torch.render.image_io import read_png
from dyadic_interaction_modeling_tpu_torch.utils import logging as TLog
from dyadic_interaction_modeling_tpu_torch.utils import observability as TO
from dyadic_interaction_modeling_tpu_torch.utils import profiling as TP
from dyadic_interaction_modeling_tpu_torch.utils import schedules as TS
from dyadic_interaction_modeling_tpu_torch.utils.seeding import set_random_seed

# the least each training twin writes (test_postprocess_cli.py:101-103,
# :119-120, :168-169, :208-209)
RUN_RECORD_TAGS = {
    "train_vq": ["train/rec_loss", "train/quant_loss", "train/perplexity", "val/rec_loss",
                 "val/quant_loss", "val/perplexity"],
    "train_s2s_pretrain": ["val/l_ce_l", "val/loss", "learning_rate"],
    "train_s2s": ["train/loss", "val/loss", "learning_rate"],
    "train_s2s --continuous": ["val/loss", "learning_rate"],
    "finetune_s2s_pretrain": ["val/fid_pose", "val/fid_exp", "learning_rate"],
}


@pytest.fixture
def no_tensorboard(monkeypatch):
    """``torch.utils.tensorboard`` made unimportable for the test."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def assert_run_record(save_dir, twin):
    """``save_dir`` holds the run record of ``twin``: ``scalars.jsonl`` with
    at least its tags, their values finite (a battery scalar such as rpcc may
    be NaN on tiny synthetic runs, in both packages), and ``hparams.json``;
    no event files, the mirror being off."""
    with open(os.path.join(save_dir, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    missing = set(RUN_RECORD_TAGS[twin]) - {r["tag"] for r in lines}
    assert not missing, f"{twin}: missing scalar tags {missing}"
    assert all(np.isfinite(r["value"]) for r in lines if r["tag"] in RUN_RECORD_TAGS[twin])
    with open(os.path.join(save_dir, "hparams.json")) as f:
        assert json.load(f)
    assert not [n for n in os.listdir(save_dir) if n.startswith("events.out.tfevents")]


def test_make_grid_and_to_uint8_match_jax():
    imgs = np.random.default_rng(0).uniform(-1.2, 1.2, (5, 4, 6, 3)).astype(np.float32)
    for nrow, pad in ((3, 1), (8, 2), (1, 0)):
        grid = TO.make_grid(imgs, nrow=nrow, pad=pad)
        np.testing.assert_array_equal(grid, JO.make_grid(imgs, nrow=nrow, pad=pad))
        for rng in ((-1.0, 1.0), (0.0, 1.0)):
            np.testing.assert_array_equal(TO.to_uint8(grid, rng), JO.to_uint8(grid, rng))
    assert TO.make_grid(imgs, nrow=3, pad=1).shape == (2 * 5 + 1, 3 * 7 + 1, 3)


def _write(module, log_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    img = np.random.default_rng(1).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    gray = np.random.default_rng(2).uniform(0, 1, (2, 5, 5, 1)).astype(np.float32)
    w = module.MetricsWriter(log_dir, hparams={"lr": 1e-4, "depth": 4, "note": [1, 2],
                                               "flag": True, "name": "vq"})
    w.add_scalar("loss", 1.5, step=0)
    w.add_scalars({"loss": 1.25, "acc": np.float32(0.5)}, step=1, prefix="train/")
    paths = [w.add_image_grid("snap", [img, img], step=3, nrow=4),
             w.add_image_grid("gray", [gray], step=12, value_range=(0.0, 1.0))]
    w.close()
    return paths


def test_metrics_writer_writes_what_the_jax_writer_writes(tmp_path, monkeypatch):
    jax_paths = _write(JO, str(tmp_path / "jax"), monkeypatch)
    port_paths = _write(TO, str(tmp_path / "port"), monkeypatch)
    for name in ("scalars.jsonl", "hparams.json"):
        with open(tmp_path / "jax" / name) as a, open(tmp_path / "port" / name) as b:
            assert a.read() == b.read(), name
    assert [os.path.relpath(p, tmp_path / "port") for p in port_paths] == [
        os.path.relpath(p, tmp_path / "jax") for p in jax_paths] == [
        os.path.join("images", "snap_000000003.png"), os.path.join("images", "gray_000000012.png")]
    for a, b in zip(jax_paths, port_paths):
        np.testing.assert_array_equal(read_png(b), read_png(a))
    with open(tmp_path / "port" / "hparams.json") as f:
        assert json.load(f)["note"] == "[1, 2]"


def test_metrics_writer_mirrors_to_tensorboard_when_it_imports(tmp_path, monkeypatch):
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def __getattr__(self, name):
            return lambda *a, **k: calls.append((name, a, k))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    w = TO.MetricsWriter(str(tmp_path), hparams={"lr": 0.1})
    w.add_scalar("loss", 2, 5)
    w.add_image_grid("g", [np.zeros((1, 4, 4, 3), np.float32)], 7)
    w.close()
    names = [c[0] for c in calls]
    assert names == ["init", "add_hparams", "add_scalar", "add_image", "close"]
    assert calls[2][1] == ("loss", 2.0, 5) and calls[3][2] == {"dataformats": "HWC"}
    no_mirror = TO.MetricsWriter(str(tmp_path / "off"), use_tensorboard=False)
    no_mirror.close()
    assert len(calls) == 5


@pytest.mark.parametrize("kind,kw", [
    ("constant", {}), ("poly", {"max_iter": 50, "power": 0.9}),
    ("step", {"step_size": 7, "gamma": 0.5}),
    ("poly", {"max_iter": 50, "warmup_steps": 10}),
    ("step", {"step_size": 4, "gamma": 0.2, "warmup_steps": 5})])
def test_lr_schedules_match_jax(kind, kw):
    base = 3e-4
    want = JS.make_lr_schedule(kind, base, **kw)
    factor = TS.make_lr_schedule(kind, **kw)
    last = 50 + kw.get("warmup_steps", 0) if kind == "poly" else 60
    for step in range(last):
        np.testing.assert_allclose(base * factor(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{kind} step {step}")
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=base)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    for step in range(1, 12):
        opt.step()
        sched.step()
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(step)), rtol=1e-6,
                                   atol=1e-12)
    for epoch in (0, 5, 9, 10, 31):
        assert TS.step_learning_rate(0.1, epoch, 10) == JS.step_learning_rate(0.1, epoch, 10)
        assert TS.poly_learning_rate(0.1, epoch, 40) == JS.poly_learning_rate(0.1, epoch, 40)
    with pytest.raises(ValueError):
        TS.make_lr_schedule("cosine")


def test_set_random_seed_repeats_every_stream():
    def draws():
        return (random.random(), np.random.rand(), torch.rand(3).tolist(),
                torch.randint(0, 100, (2,)).tolist())

    set_random_seed(131)
    first = draws()
    set_random_seed(131)
    assert draws() == first
    set_random_seed(132)
    assert draws() != first


def test_logger_meter_and_main_process():
    logger = TLog.get_logger("port-test-logger")
    assert TLog.get_logger("port-test-logger") is logger and len(logger.handlers) == 1
    m = TLog.AverageMeter()
    for v, n in ((1.0, 1), (4.0, 3)):
        m.update(torch.tensor(v), n)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 13.0, 4, 3.25)
    assert TLog.main_process()


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    """``trace`` turns the span recorder on and writes the spans into its
    Chrome trace, a track of their own, on the profiler's clock."""
    x = torch.randn(64, 64)
    with TP.trace(str(tmp_path / "trace")) as prof:
        with TP.span("step", i=3):
            time.sleep(1e-4)  # the clocks need agree within 0.1 ms only
            torch.mm(x, x)
            time.sleep(1e-4)
    assert any("mm" in e.key for e in prof.key_averages())
    with TP.recording() as spans:
        pass
    assert TP.span("step") is TP.span("other") and spans == []  # off after the block
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (step,) = [e for e in events if e.get("cat") == "span"]
    assert step["name"] == "step" and step["args"]["i"] == 3 and step["pid"] == TP.SPAN_PID
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert step["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= step["ts"] + step["dur"]
    assert {"ph": "M", "name": "process_name", "pid": TP.SPAN_PID, "tid": 0,
            "args": {"name": "spans"}} in events


def test_vq_train_epoch_writes_the_jax_batch_scalars(tmp_path, monkeypatch):
    """``engine.vq_engine.train_epoch`` at the print cadence writes what the
    JAX loop writes (train_vq.py:230-233 tags) for the same metrics."""
    from dyadic_interaction_modeling_tpu.engine import vq_engine as JE
    from dyadic_interaction_modeling_tpu_torch.engine import vq_engine as TE

    rng = np.random.default_rng(4)
    steps = [{k: np.float32(v) for k, v in zip(TE.METRICS, rng.uniform(0, 2, 4))}
             for _ in range(7)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    kw = dict(epoch=1, print_freq=3, step_offset=14, lr=1e-4)
    for name, run in (
            ("jax", lambda w: JE.train_epoch(None, range(7), lambda s, i: (s, steps[i]),
                                             writer=w, **kw)[1]),
            ("port", lambda w: TE.train_epoch(range(7), lambda i: {
                k: torch.tensor(v) for k, v in steps[i].items()}, writer=w, **kw))):
        writer = TO.MetricsWriter(str(tmp_path / name))
        last = run(writer)
        writer.close()
        assert last == pytest.approx({k: float(v) for k, v in steps[-1].items()})
    with open(tmp_path / "jax" / "scalars.jsonl") as a, open(tmp_path / "port" / "scalars.jsonl") as b:
        want, got = a.read(), b.read()
    assert got == want and got.count("train_batch/loss_2") == 2  # steps 17 and 20
