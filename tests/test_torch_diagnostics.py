"""The port's diagnostics, its rho pass and the settle gate against the JAX
package, on the CPU. States come from the JAX package (spawn and cell
steps) through `interop`, so both measure the very same particles."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import diagnostics_fn as jdiagnostics
from pdb_sph_tpu.core.step import make_rollout as jmake_rollout
from pdb_sph_tpu.ops import dense as jdense
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu_torch import default_config, interop, spawn
from pdb_sph_tpu_torch.core import settle
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

torch.set_num_threads(1)

N = 2048


@pytest.fixture(scope="module")
def stepped():
    """JAX spawn n=2048 standard, 5 JAX cell steps, and the jitted JAX
    diagnostics. The cell table (a row per particle, 32 slots per cell) is
    large enough that the diagnostics drop no particle (each test checks),
    and small enough that its all-slots density pass stays cheap."""
    jcfg = jpbf.default_config(n=N, max_occupied_cells=N, cell_capacity=32,
                               block=32)
    st = jmake_rollout(jcfg, "cell", 5)(jpbf.spawn(jcfg, "standard", seed=0))
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    return cfg, st, jax.jit(functools.partial(jdiagnostics, jcfg))


def _variant(x, kind):
    x = x.copy()
    if kind == "outside":
        # two beyond the escape band, one inside it, one on the far wall
        x[:4] = [[-1.0, 0.5, 0.5], [3.0, 1.0, 1.0], [0.5, -0.1, 0.5],
                 [0.7, 0.7, 2.0]]
    elif kind == "nan":
        x[7, 1] = np.nan
    return x


@pytest.mark.parametrize("kind", ["stepped", "outside", "nan"])
def test_diagnostics_match_jax(stepped, kind):
    cfg, st, jdiag = stepped
    x = _variant(np.asarray(st.x), kind)
    want = jdiag(st._replace(x=jnp.asarray(x)))
    assert int(want.n_overflow) == 0  # the JAX table kept every particle
    got = tstep.diagnostics_fn(
        cfg, interop.state_from_numpy(x, st.v, st.ids, st.step, "cpu"))
    assert all(t.dim() == 0 for t in got)
    np.testing.assert_allclose(float(got.mean_density),
                               float(want.mean_density), rtol=1e-5)
    np.testing.assert_allclose(float(got.max_density_err),
                               float(want.max_density_err), atol=1e-5)
    np.testing.assert_allclose(float(got.max_speed), float(want.max_speed),
                               rtol=1e-6)
    assert int(got.n_escaped) == int(want.n_escaped)
    assert bool(got.nan_detected) == bool(want.nan_detected)
    assert int(got.n_overflow) == 0 and int(got.plan_overflow) == 0
    assert got.n_escaped.dtype == torch.int32
    assert got.nan_detected.dtype == torch.bool
    if kind == "outside":
        assert int(got.n_escaped) == 2
    if kind == "nan":
        assert bool(got.nan_detected)


def test_diagnostics_leave_the_stepper_buffers_alone():
    cfg = default_config(n=256)
    stepper = tstep.make_step(cfg, "window")
    state = stepper(spawn(cfg, "dam_break", seed=3))
    before = [b.clone() for b in stepper.bufs]
    tstep.diagnostics_fn(cfg, state)
    assert all(torch.equal(a, b) for a, b in zip(before, stepper.bufs))


def test_density_rho_matches_jax_dense():
    jcfg = jpbf.default_config(n=512)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    x = np.array(jpbf.spawn(jcfg, "dam_break", seed=4).x)
    want = np.asarray(jdense.density_dense(jcfg, jnp.asarray(x)))

    xt = torch.from_numpy(x)
    sorted_cid, order = tstep.sort_cells(cfg, hashgrid.cell_ids(cfg, xt))
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    p4 = torch.zeros((sorted_cid.shape[0], 4))
    p4[:512, :3] = xt[order]
    before = dict(cuda_pbf.LAUNCHES)
    out = cuda_pbf.density_rho(cfg, p4, plan, 512)
    assert cuda_pbf.LAUNCHES == before  # the CPU runs the plain version
    assert torch.equal(out, cuda_pbf.density_rho_ref(cfg, p4, plan, 512))
    assert torch.equal(out[:512, :3], p4[:512, :3])
    assert not out[512:].any()
    np.testing.assert_allclose(out[:512, 3].numpy(), want[order.numpy()],
                               rtol=1e-5)


def test_density_rho_refuses_other_devices():
    cfg = default_config(n=64)
    p4 = torch.zeros((64, 4), device="meta")
    plan = cuda_pbf.WindowPlan(
        torch.zeros((1, 9, 2), dtype=torch.int32, device="meta"),
        torch.zeros((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        cuda_pbf.density_rho(cfg, p4, plan, 64)


def test_nan_cell_id_is_jax_cell_zero():
    """A NaN coordinate lands in cell 0 on that axis, as JAX converts it
    (the CPU's float->int32 conversion alone would give INT_MIN)."""
    jcfg = jpbf.default_config(n=4)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    x = np.array([[np.nan, 0.5, 0.5], [0.5, np.nan, np.nan],
                  [np.inf, -np.inf, 0.3], [0.15, 0.25, 0.35]], np.float32)
    got = hashgrid.cell_ids(cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhash.cell_ids(jcfg, x)))


GOOD = dict(mean_density=6606.0, rho0=6378.0, max_speed=0.2, n_escaped=0,
            stats=[0, 0, 0], nan=False)


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    (dict(mean_density=6378.0 * 1.049), True),
    (dict(mean_density=6378.0 * 1.051), False),
    (dict(mean_density=6378.0 * 0.94), False),
    (dict(max_speed=0.5), False),
    (dict(n_escaped=1), False),
    (dict(stats=[0, 1, 0]), False),
    (dict(stats=[0, 0, 3]), False),
    (dict(nan=True), False),
])
def test_settle_criteria(change, ok):
    assert settle.settled(**{**GOOD, **change}) is ok


# 150 steps: one whole chunk of CHUNK and a shorter last one
@pytest.mark.parametrize("steps", [20, 150])
def test_settle_check_short_run(steps):
    r = settle.settle_check("cpu", n=512, steps=steps)
    assert r["step"] == steps and r["n"] == 512
    assert r["stats"] == [0, 0, 0] and r["nan"] is False
    assert r["n_escaped"] == 0 and r["rho0"] == 6378.0
    assert np.isfinite(r["mean_density"]) and r["mean_density"] > 0
    assert r["max_speed"] > 0 and r["seconds"] > 0
    assert r["ok"] == settle.settled(r["mean_density"], r["rho0"],
                                     r["max_speed"], r["n_escaped"],
                                     r["stats"], r["nan"])
    assert "SETTLE CHECK: " in settle.format_result(r)


def test_settle_check_runs_the_geometry_it_is_given():
    geom = dataclasses.replace(default_config(n=512).geom, mxu_rd2=True,
                               mxu_proj=True, mxu_sum=True)
    r = settle.settle_check("cpu", n=512, steps=20, geom=geom)
    base = settle.settle_check("cpu", n=512, steps=20)
    assert r["step"] == 20 and r["stats"] == [0, 0, 0] and r["nan"] is False
    assert np.isfinite(r["mean_density"]) and r["n_escaped"] == 0
    # the tensor-core forms are another function: the states differ
    assert r["mean_density"] != base["mean_density"] \
        or r["max_speed"] != base["max_speed"]
