"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Import names are compared by
their whole top-level name: `pdb_sph_tpu_torch` begins with `pdb_sph_tpu`
but is not it."""

import ast

import pytest

from pbfbench import harness

MODULES = sorted(p for p in harness.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    """The top-level names of every import in a file; a relative import
    names the benchmark's own package."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("pbfbench" if node.level else
                      node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def test_the_walk_finds_the_modules():
    rel = {p.relative_to(harness.HERE).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "reference/pbf.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.name for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


def test_the_whole_name_is_compared():
    import tempfile
    from pathlib import Path

    src = ("import pdb_sph_tpu_torch.ops\nfrom jaxtyping import x\n"
           "import pdb_sph_tpu.core as c\n")
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text(src)
        found = top_level_imports(p)
    assert found == {"pdb_sph_tpu_torch", "jaxtyping", "pdb_sph_tpu"}
    assert found & set(harness.FORBIDDEN) == {"pdb_sph_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert "pdb_sph_tpu_torch" not in top_level_imports(path)
    for path in (harness.HERE / "neighbours.py", harness.HERE / "work.py"):
        assert "pdb_sph_tpu_torch" not in top_level_imports(path)


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "pdb_sph_tpu_torch_x",
                        types.ModuleType("pdb_sph_tpu_torch_x"))
    assert not [m for m in harness.jax_modules() if m.startswith("pdb_")]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax.numpy" in harness.jax_modules()
