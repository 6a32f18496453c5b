"""Nothing under gossipbench imports JAX or the JAX package (by whole
top-level name: ``consul_tpu_torch`` is another name), and the
reference imports nothing of the program."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(ROOT.rglob("*.py"))


def top_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "consul_tpu"}


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "consul_tpu_torch" not in top_names(path)
    assert top_names(path) <= {"torch", "math", "typing", "gossipbench",
                               "__future__"}


def test_the_scan_sees_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom consul_tpu.sim import x\n")
    assert top_names(f) == {"jax", "consul_tpu"}
