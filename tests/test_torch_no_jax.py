"""The torch port stands alone: neither it nor chip_smoke.py imports jax,
flax or the JAX package; it imports with those modules blocked; its entry
points default to the GPU; chip_smoke.py refuses to run without one."""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "dyadic_interaction_modeling_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dyadic_interaction_modeling_tpu"}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_port_or_chip_smoke():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'dyadic_interaction_modeling_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import dyadic_interaction_modeling_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = set(proc.stdout.split())
    assert len(names) >= 20
    # the training stages' modules (VQ tokenizer training, SLMFT finetune)
    # and the CLIs' files, configs and checkpoints
    assert {f"dyadic_interaction_modeling_tpu_torch.{m}" for m in (
        "cli.train_vq", "cli.finetune_s2s_pretrain", "engine.vq_engine",
        "utils.checkpoint", "metrics.loss", "cli.common", "data.datasets",
        "data.reference_files", "models", "models.wav2vec2", "models.hubert",
        "models.codetalker", "metrics.sentiment", "cli.train_stage2", "serving.audio",
        "utils.logging", "utils.seeding", "utils.schedules", "utils.observability",
        "utils.profiling", "utils.lmdb_lite", "render", "render.image_io", "render.config",
        "render.flow", "render.generator", "render.data", "render.inference",
        "cli.render_inference", "cli.intuitive_control")} <= names


def test_entry_points_default_to_cuda():
    from dyadic_interaction_modeling_tpu_torch.cli import (
        finetune_s2s_pretrain, train_s2s_pretrain, train_stage2, train_vq)
    from dyadic_interaction_modeling_tpu_torch.cli.test_s2s_pretrain import get_parser
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import evaluate_test_epoch

    assert get_parser().parse_args(["--synthetic"]).device == "cuda"
    from dyadic_interaction_modeling_tpu_torch.cli import intuitive_control, render_inference

    for twin in (train_s2s_pretrain, train_vq, finetune_s2s_pretrain, train_stage2,
                 render_inference, intuitive_control):
        assert twin.get_parser().parse_args(["--synthetic"]).device == "cuda", twin.__name__
    assert inspect.signature(evaluate_test_epoch).parameters["device"].default == "cuda"
    from dyadic_interaction_modeling_tpu_torch.metrics.sentiment import train_probe
    from dyadic_interaction_modeling_tpu_torch.models.hubert import make_hubert_extractor

    for fn in (make_hubert_extractor, train_probe):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = _run_chip_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
