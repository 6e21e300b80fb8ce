"""The port's SimConfig against the JAX package's, and the port's imports."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from pdb_sph_tpu import config as jconfig
from pdb_sph_tpu import geometry as jgeometry
from pdb_sph_tpu_torch import config as tconfig
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.geometry import KernelGeometry, geometry_from_env

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


SHARED = ("own", "mxu_sum", "mxu_rd2", "mxu_proj")


@pytest.mark.parametrize("env", [
    {},
    {"PBF_OWN": "128", "PBF_MXU_RD2": "1"},
    {"PBF_MXU_SUM": "1", "PBF_MXU_PROJ": "1", "PBF_CC": "512", "PBF_GB": "8"},
    {"PBF_OWN": "32", "PBF_MXU_RD2": "true", "PBF_MXU_SUM": "0",
     "PBF_MXU_PROJ": "1"},
])
def test_geometry_from_env_matches_jax(env):
    t, j = geometry_from_env(env), jgeometry.geometry_from_env(env)
    assert {k: getattr(t, k) for k in SHARED} == \
        {k: getattr(j, k) for k in SHARED}
    assert t.seg == KernelGeometry().seg  # no knob of the port's own


def test_empty_env_gives_the_default_geometry():
    assert geometry_from_env({}) == KernelGeometry()
    assert not (KernelGeometry().mxu_sum or KernelGeometry().mxu_rd2
                or KernelGeometry().mxu_proj)


def test_default_config_reads_the_tensor_core_switches(monkeypatch):
    for name in ("PBF_MXU_SUM", "PBF_MXU_RD2", "PBF_MXU_PROJ", "PBF_OWN"):
        monkeypatch.delenv(name, raising=False)
    assert tconfig.default_config(n=256).geom == KernelGeometry()
    monkeypatch.setenv("PBF_MXU_RD2", "1")
    monkeypatch.setenv("PBF_MXU_PROJ", "1")
    g = tconfig.default_config(n=256).geom
    assert (g.mxu_rd2, g.mxu_proj, g.mxu_sum) == (True, True, False)
    # an explicit geometry wins over the environment
    cfg = tconfig.default_config(n=256, geom=KernelGeometry())
    assert cfg.geom == KernelGeometry()


def test_config_from_fields_carries_the_jax_switches():
    jgeom = dataclasses.replace(jgeometry.KernelGeometry(), own=128, gb=8,
                                cc_d=512, mxu_rd2=True, mxu_sum=True)
    j = jconfig.default_config(n=300, geom=jgeom)
    t = interop.config_from_fields(dataclasses.asdict(j))
    _assert_same(t, j)
    assert t.geom == KernelGeometry(own=128, mxu_rd2=True, mxu_sum=True)


@pytest.mark.parametrize("bad", [dict(own=48), dict(own=512), dict(seg=0),
                                 dict(seg=100), dict(seg=-512),
                                 dict(own=16)])
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
