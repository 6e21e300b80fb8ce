"""The port stands on its own: no module of it, nor chip_smoke.py or
benchmarks_torch/, imports the JAX package or reads one of its files; its
renderer builds its own copy of the rasterizer source; and its entry points
run on the card unless the caller asks for the CPU."""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pdb_sph_tpu_torch import cli
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.io import checkpoint
from pdb_sph_tpu_torch.models import scenes
from pdb_sph_tpu_torch.parallel import launch, sharded
from pdb_sph_tpu_torch.render import renderer
from pdb_sph_tpu_torch.utils import platform

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pdb_sph_tpu_torch"
SOURCES = sorted([*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
                  *(ROOT / "benchmarks_torch").glob("*.py")])

# `import pdb_sph_tpu`, `from pdb_sph_tpu(.x) import`, not the port's name
JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+pdb_sph_tpu(?!_torch)\b", re.MULTILINE)
# a path built from the JAX package's directory name
JAX_PATH = re.compile(
    r"""["']pdb_sph_tpu["']\s*/|/\s*["']pdb_sph_tpu["']"""
    r"""|join\([^)]*["']pdb_sph_tpu["']""")

ENTRY_POINTS = {
    "Stepper": tstep.Stepper,
    "Rollout": tstep.Rollout,
    "make_step": tstep.make_step,
    "make_rollout": tstep.make_rollout,
    "spawn": scenes.spawn,
    "checkpoint.load": checkpoint.load,
    "make_sharded_step": sharded.make_sharded_step,
    "make_sharded_rollout": sharded.make_sharded_rollout,
    "ShardedStepper": sharded.ShardedStepper,
    "distribute": sharded.distribute,
}

# the modules of the cell backend and the sharded path, and the runner
NEW_MODULES = ("pdb_sph_tpu_torch.ops.hashgrid",
               "pdb_sph_tpu_torch.ops.cell_list",
               "pdb_sph_tpu_torch.parallel.comm",
               "pdb_sph_tpu_torch.parallel.sharded",
               "pdb_sph_tpu_torch.parallel.launch",
               "pdb_sph_tpu_torch.cli")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_package_import_or_path(path):
    text = path.read_text()
    assert not JAX_IMPORT.search(text), f"{path} imports pdb_sph_tpu"
    assert not JAX_PATH.search(text), f"{path} builds a pdb_sph_tpu path"


def test_renderer_source_is_the_ports_own_copy():
    source = renderer.SOURCE.resolve()
    assert source.is_relative_to(PORT.resolve())
    jax_copy = ROOT / "pdb_sph_tpu" / "render" / "cpp" / "rasterizer.cpp"
    assert source.read_bytes() == jax_copy.read_bytes()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


def test_card_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            platform.resolve_device(device)
    assert platform.resolve_device("cpu") == torch.device("cpu")


def test_sharded_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, as a spawned rank starts."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' "
              "or m.startswith('jax.') or m == 'pdb_sph_tpu' "
              "or m.startswith('pdb_sph_tpu.')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("fn", [launch._rollout_rank, cli._mesh_rank],
                         ids=["rollout_rank", "mesh_rank"])
def test_rank_workers_live_in_the_port(fn):
    """A spawned rank imports the module of its function, never a test."""
    assert fn.__module__.startswith("pdb_sph_tpu_torch.")
    assert fn.__qualname__ == fn.__name__  # module level: importable
