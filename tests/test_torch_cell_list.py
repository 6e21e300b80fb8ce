"""The port's cell table and `cell` backend against the JAX package's, on
the CPU, from the very same particles (JAX spawn -> numpy).

The JAX tables stay small (capacity 16, at most 1024 rows): a JAX cell
pass costs rows x 27 x capacity^2 pair terms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import make_step as jmake_step
from pdb_sph_tpu.core.step import step_fn as jstep_fn
from pdb_sph_tpu.ops import cell_list as jcl
from pdb_sph_tpu.ops import hashgrid as jhg
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.ops import cell_list, hashgrid

torch.set_num_threads(1)

# the tables' shapes: capacity 16 holds the densest cell of these scenes
CAP = 16
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-9
# 3 steps, compared after un-sorting by ids (ROADMAP "Parity method")
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


def _pair(n, scene, seed=0, **kw):
    kw = {"cell_capacity": CAP, "block": CAP, **kw}
    jcfg = jpbf.default_config(n=n, **kw)
    st = jpbf.spawn(jcfg, scene, seed=seed)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, cfg, st, interop.state_from_numpy(st.x, st.v, st.ids,
                                                   st.step, "cpu")


def _grids(jcfg, cfg, x, ignore_every=0):
    """The JAX and port grids of the same sorted cell ids; with
    ignore_every, every such particle takes the ignored cell id."""
    cid = np.asarray(jhg.cell_ids(jcfg, x))
    ignore = None
    if ignore_every:
        ignore = cfg.num_nb_cells
        cid = cid.copy()
        cid[::ignore_every] = ignore
    order = np.argsort(cid, kind="stable").astype(np.int32)
    sorted_cid = cid[order]
    jg = jhg.build_grid(jcfg, jnp.asarray(sorted_cid), jnp.asarray(order),
                        ignore_cell=ignore)
    tg = hashgrid.build_grid(cfg, torch.from_numpy(sorted_cid),
                             torch.from_numpy(order).long(),
                             ignore_cell=ignore)
    return jg, tg, order


GRID_CASES = {
    "fits": dict(n=1024, max_occupied_cells=1024),
    "rows_overflow": dict(n=1024, max_occupied_cells=256),
    "ignored_cell": dict(n=1024, max_occupied_cells=1024, ignore_every=7),
    "ignored_and_rows_overflow": dict(n=2048, max_occupied_cells=512,
                                      ignore_every=5),
}


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_and_tables_equal_jax_integer_for_integer(case):
    kw = dict(GRID_CASES[case])
    ignore_every = kw.pop("ignore_every", 0)
    n = kw.pop("n")
    jcfg, cfg, st, _ = _pair(n, "dam_break", **kw)
    jg, tg, order = _grids(jcfg, cfg, st.x, ignore_every)
    for name in ("row", "col", "counts", "nbr", "n_overflow"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    if "overflow" in case:
        assert int(tg.n_overflow) > 0
    np.testing.assert_array_equal(hashgrid.slot_masks(cfg, tg).numpy(),
                                  np.asarray(jhg.slot_masks(jcfg, jg)))
    vals = np.asarray(st.x)[order, 0] + 1.0  # no value is 0, the fill
    jt = np.asarray(jhg.scatter_table(jcfg, jg, jnp.asarray(vals)))
    tt = hashgrid.scatter_table(cfg, tg, torch.from_numpy(vals))
    np.testing.assert_array_equal(tt.numpy(), jt)
    fallback = -np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(
        hashgrid.gather_table(cfg, tg, tt, torch.from_numpy(fallback)).numpy(),
        np.asarray(jhg.gather_table(jcfg, jg, jnp.asarray(jt),
                                    jnp.asarray(fallback))))


@pytest.mark.parametrize("scene", ["dam_break", "blowup"])
def test_table_passes_match_jax(scene):
    """density_lambda_tables, project_tables and density_tables on the same
    tables, at rtol 1e-5."""
    jcfg, cfg, st, _ = _pair(1024, scene, max_occupied_cells=1024)
    jg, tg, order = _grids(jcfg, cfg, st.x)
    xs = np.asarray(st.x)[order]
    jt = [jhg.scatter_table(jcfg, jg, jnp.asarray(xs[:, a])) for a in range(3)]
    tt = cell_list.position_tables(cfg, tg, torch.from_numpy(xs))
    jlam = jcl.density_lambda_tables(jcfg, *jt, jg)
    tlam = cell_list.density_lambda_tables(cfg, *tt, tg)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam),
                               rtol=TABLE_RTOL, atol=TABLE_ATOL)
    jdp = jcl.project_tables(jcfg, *jt, jlam, jg)
    tdp = cell_list.project_tables(cfg, *tt, torch.tensor(np.asarray(jlam)),
                                   tg)
    for a in range(3):
        np.testing.assert_allclose(tdp[a].numpy(), np.asarray(jdp[a]),
                                   rtol=TABLE_RTOL, atol=TABLE_ATOL)
    np.testing.assert_allclose(
        cell_list.density_tables(cfg, *tt, tg).numpy(),
        np.asarray(jcl.density_tables(jcfg, *jt, jg)), rtol=TABLE_RTOL,
        atol=TABLE_ATOL)


def _unsort(x, ids):
    return np.asarray(x)[np.argsort(np.asarray(ids))]


@pytest.mark.parametrize("n,scene,cap", [(512, "dam_break", 16),
                                         (1024, "blowup", 16)])
def test_cell_steps_match_jax_cell(n, scene, cap):
    jcfg, cfg, a, b = _pair(n, scene, max_occupied_cells=1024,
                            cell_capacity=cap, block=cap)
    jstep = jmake_step(jcfg, backend="cell")
    stepper = tstep.make_step(cfg, "cell", device="cpu")
    for _ in range(3):
        a = jstep(a)
        b, stats = stepper.step(b, with_stats=True)
        assert stats.tolist() == [0, 0, 0]
    np.testing.assert_allclose(_unsort(b.x.numpy(), b.ids.numpy()),
                               _unsort(a.x, a.ids), rtol=STEP_RTOL,
                               atol=STEP_ATOL)


@pytest.mark.parametrize("kw", [dict(max_occupied_cells=256),
                                dict(max_occupied_cells=1024,
                                     cell_capacity=2, block=2)],
                         ids=["rows", "slots"])
def test_forced_table_overflow_counts_equal_jax(kw):
    """A table too small for the particles: both packages drop and count
    the same particles, and the dropped ones keep finite positions."""
    jcfg = jpbf.default_config(n=1024, **{"cell_capacity": CAP,
                                          "block": CAP, **kw})
    st = jpbf.spawn(jcfg, "dam_break", seed=3)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    b = interop.state_from_numpy(st.x, st.v, st.ids, st.step, "cpu")
    a, jstats = jstep_fn(jcfg, "cell", st, with_stats=True)
    b, stats = tstep.make_step(cfg, "cell", device="cpu").step(
        b, with_stats=True)
    assert stats.tolist() == np.asarray(jstats).tolist()
    assert stats[0] > 0 and stats[1] == 0
    assert torch.isfinite(b.x).all()
    np.testing.assert_allclose(_unsort(b.x.numpy(), b.ids.numpy()),
                               _unsort(a.x, a.ids), rtol=STEP_RTOL,
                               atol=STEP_ATOL)
