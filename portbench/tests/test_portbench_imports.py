"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the references import nothing of the port."""

from __future__ import annotations

import ast

from portbench.harness.cell import BENCH
from portbench.harness.imports import FORBIDDEN, forbidden_loaded

PORT = "dyadic_interaction_modeling_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    bad = {str(p): sorted(set(_imports(p)) & set(FORBIDDEN)) for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_references_import_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert PORT not in set(_imports(p)), p


def test_whole_names_are_compared():
    assert forbidden_loaded([PORT, f"{PORT}.models", "jaxtyping", "flax_like"]) == []
    assert forbidden_loaded(["jax.numpy", "dyadic_interaction_modeling_tpu.models"]) == [
        "dyadic_interaction_modeling_tpu", "jax"]
