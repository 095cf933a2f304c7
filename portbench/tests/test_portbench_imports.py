"""Nothing the benchmark runs loads JAX or the JAX package, compared by
each module's whole top-level name; the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent


def top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla"], ["jaxlib"]),
    (["flax.linen"], ["flax"]), (["pharmaforge_tpu"], ["pharmaforge_tpu"]),
    (["pharmaforge_tpu.models.gvp"], ["pharmaforge_tpu"]),
    (["pharmaforge_tpu_torch", "pharmaforge_tpu_torch.models"], []),
    (["jaxtyping", "flaxen", "pharmaforge_tpu_extra"], [])])
def test_whole_word_check(monkeypatch, names, found):
    modules = {k: v for k, v in sys.modules.items()
               if k.split(".")[0] not in harness.FORBIDDEN}
    for n in names:
        modules[n] = object()
    monkeypatch.setattr(sys, "modules", modules)
    assert harness.forbidden_loaded() == found


def test_no_file_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        bad = set(top_names(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        names = set(top_names(path))
        assert "pharmaforge_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "typing", "pathlib",
                         "numpy", "torch", "portbench"}, (path, names)


def test_no_forbidden_module_is_loaded_here():
    # the benchmark's own modules, imported by these tests
    assert "jax" not in {n.split(".")[0] for n in sys.modules
                         if n.startswith("portbench")}
