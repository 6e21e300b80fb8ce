"""The port's scenes: shapes, bounds and moments, against the JAX scenes'
moments (torch and jax.random draw different numbers for one seed)."""

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
import pdb_sph_tpu_torch as tpbf

torch.set_num_threads(1)

N = 4096
TCFG = tpbf.default_config(n=N)
JCFG = jpbf.default_config(n=N)


@pytest.mark.parametrize("scene", tpbf.SCENES)
def test_scene_shapes_dtypes_and_moments(scene):
    st = tpbf.spawn(TCFG, scene, seed=0)
    assert st.x.shape == (N, 3) and st.x.dtype == torch.float32
    assert st.v.shape == (N, 3) and not st.v.any()
    assert st.ids.dtype == torch.int32
    assert st.ids.tolist() == list(range(N))
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    x = st.x.numpy()
    jx = np.asarray(jpbf.spawn(JCFG, scene, seed=0).x)
    # per-axis mean and spread agree to sampling noise (~0.01 at n=4096)
    np.testing.assert_allclose(x.mean(0), jx.mean(0), atol=0.03)
    np.testing.assert_allclose(x.std(0), jx.std(0), atol=0.02)


def test_scene_reproducible_and_seeded():
    a = tpbf.spawn(TCFG, "standard", seed=7)
    b = tpbf.spawn(TCFG, "standard", seed=7)
    c = tpbf.spawn(TCFG, "standard", seed=8)
    assert torch.equal(a.x, b.x)
    assert not torch.equal(a.x, c.x)


def test_standard_in_unit_cube():
    x = tpbf.spawn(TCFG, "standard", 0).x
    assert (x >= 0).all() and (x < 1).all()


def test_dam_break_block():
    x = tpbf.spawn(TCFG, "dam_break", 0).x
    assert (x >= 0).all()
    assert x[:, 0].max() <= 0.5 and x[:, 1].max() <= TCFG.wall
    assert x[:, 2].max() <= 1.0


def test_blowup_in_ball():
    x = tpbf.spawn(TCFG, "blowup", 0).x
    r = torch.linalg.vector_norm(x - TCFG.wall / 2, dim=1)
    assert r.max() <= 0.5 + 1e-5
    assert abs(float(r.mean()) - 0.375) < 0.02


def test_unknown_scene_raises():
    with pytest.raises(ValueError):
        tpbf.spawn(TCFG, "nope")
