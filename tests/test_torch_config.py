"""The port's SimConfig against the JAX package's, and the port's imports."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from pdb_sph_tpu import config as jconfig
from pdb_sph_tpu_torch import config as tconfig
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.geometry import KernelGeometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DERIVED = ("domain_extent", "nb_cell", "nb_domain_extent", "nb_grid_width",
           "num_nb_cells", "h2", "inv_rho0", "poly6_coeff",
           "spiky_grad_coeff", "lambda_grad_coeff")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "geom"}


def _assert_same(t, j):
    assert _fields(t) == _fields(j)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("factory,kw", [
    ("default_config", dict(n=80_000)),
    ("default_config", dict(n=256)),
    ("blowup_config", {}),
])
def test_fields_and_derived_constants_match_jax(factory, kw):
    _assert_same(getattr(tconfig, factory)(**kw),
                 getattr(jconfig, factory)(**kw))


def test_scene_names_match_jax():
    assert tconfig.SCENES == jconfig.SCENES


def test_config_from_fields_carries_a_jax_config():
    j = jconfig.default_config(n=300, wall=3.0, s_corr=2e-4,
                               strict_reference_collide=True)
    t = interop.config_from_fields(dataclasses.asdict(j))
    _assert_same(t, j)
    assert t.geom == KernelGeometry()
    with pytest.raises(ValueError):
        interop.config_from_fields({**_fields(j), "bogus": 1})


@pytest.mark.parametrize("bad", [dict(own=48), dict(own=512), dict(tile=0),
                                 dict(tile=100), dict(tile=4096)])
def test_geometry_validation_rejects_bad_knobs(bad):
    with pytest.raises(ValueError):
        tconfig.default_config(n=256, geom=KernelGeometry(**bad))


def test_import_loads_no_jax():
    """The port must not import jax (pdb_sph_tpu's __init__ does). Run in a
    subprocess: this test process already imported jax."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import pdb_sph_tpu_torch, pdb_sph_tpu_torch.interop\n"
        "import pdb_sph_tpu_torch.ops.cuda_pbf, pdb_sph_tpu_torch.ops.dense\n"
        "import pdb_sph_tpu_torch.utils.cuda_build\n"
        "import pdb_sph_tpu_torch.utils.timing\n"
        "import pdb_sph_tpu_torch.cli, pdb_sph_tpu_torch.core.settle\n"
        "import pdb_sph_tpu_torch.io.checkpoint, pdb_sph_tpu_torch.io.frames\n"
        "import pdb_sph_tpu_torch.render.renderer\n"
        "import pdb_sph_tpu_torch.utils.logging\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pdb_sph_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
