"""The long-horizon sharded soak of the port: the counterpart of
tests/test_sharded_soak.py on gloo ranks on the CPU.

The port's move rule is not JAX's (parallel/sharded.py `_move_bounds`: no
strip over mig_capacity is donated, and no recipient limit), so JAX's
invariants (`parallel.soak.check`: counts, overflow, NaN, bounds rows,
slab widths after every chunk; moves, imbalance and the final state over
the run) are held here over its horizon, 10 chunks of 25 steps through
`launch.rollout_ranks` on the window backend.

The legs: JAX's two at its D = 8 with its limits (the blowup passes a
transient in which the exploding shell leaves row-sized hot spots), and
the dam break at D = 4 through a re-tier before chunk 4, which puts the
compact tier's 150 steps under the same invariants. The cell backend's
plain passes would cost max_occupied_cells x 27 x cell_capacity^2 a pass
on this table, minutes a step here: the window backend has no table.

The check itself is held against runs made to break each invariant.
"""

import pytest
import torch

from pdb_sph_tpu_torch import default_config, spawn
from pdb_sph_tpu_torch.parallel import launch, sharded, soak

torch.set_num_threads(1)

# JAX's soak config: h = 0.05 doubles the box's z-rows, so that 8 slabs of
# at least 2 rows leave the boundaries room to move
SOAK = dict(n=1024, h=0.05, max_occupied_cells=2048, cell_capacity=128)
CHUNK, CHUNKS = 25, 10
RANK_TIMEOUT_S = 300.0


@pytest.mark.parametrize("scene,D,retier,imb_limit", [
    ("dam_break", 8, None, 2.0),
    ("blowup", 8, None, 3.0),
    ("dam_break", 4, 4, 2.0),
], ids=["dam_break-d8", "blowup-d8", "dam_break-d4-retier"])
def test_sharded_soak_invariants(scene, D, retier, imb_limit):
    cfg = default_config(**SOAK)
    st = spawn(cfg, scene, seed=0, device="cpu")
    out, _ = launch.rollout_ranks(cfg, st, D, [CHUNK] * CHUNKS, "window",
                                  devices=["cpu"] * D, retier=retier,
                                  timeout_s=RANK_TIMEOUT_S)
    rows, bad = soak.check(cfg, D, st, out, [CHUNK] * CHUNKS, retier,
                           imb_limit)
    assert not bad, (bad, rows)
    assert len(rows) == CHUNKS and rows[-1]["step"] == CHUNK * CHUNKS


def _clean_run(cfg, st, D=4, chunks=(25, 25, 25)):
    """Chunks that keep every invariant: the loads even, no counter, one
    boundary a key further each chunk."""
    b = torch.from_numpy(sharded.initial_bounds(cfg, D, state=st)).int()
    out, step = [], 0
    for c, k in enumerate(chunks):
        step += k
        row = torch.cat([torch.tensor([step], dtype=torch.int32), b.clone()])
        row[2] += c + 1
        stats = torch.zeros((D, 5), dtype=torch.int32)
        stats[:, 0] = cfg.n // D
        out.append(launch.Chunk(st, stats, torch.zeros((D, 3)), 1.0,
                                torch.zeros((D, 5)), row.repeat(D, 1)))
    return out, list(chunks)


def _break(fault, got, cfg, D=4):
    """`got` with `fault` put into its last chunk."""
    last = got[-1]
    stats, diag, rows = (t.clone() for t in (last.stats, last.diag,
                                              last.bounds))
    st = last.state
    if fault == "lost":
        stats[0, 0] -= 1
    elif fault == "overflow":
        stats[2, 1] = 1
    elif fault == "nan":
        diag[1, 2] = 1.0
    elif fault == "rows_differ":
        rows[3, 2] += 1
    elif fault == "step_counter":
        rows[:, 0] += 1
    elif fault == "narrow":
        rows[:, 2] = rows[:, 1] + sharded._min_slab_keys(cfg) - 1
    elif fault == "span":
        rows[:, -1] -= 1
    elif fault == "imbalance":
        stats[:, 0] = torch.tensor([cfg.n - 3 * 8, 8, 8, 8])
    elif fault == "frozen":
        b0 = torch.from_numpy(sharded.initial_bounds(cfg, D, state=st))
        return [c._replace(bounds=torch.cat(
            [c.bounds[:, :1], b0.int().repeat(D, 1)], dim=1)) for c in got]
    elif fault == "outside":
        x = st.x.clone()
        x[5, 1] = cfg.wall + 0.3
        st = st._replace(x=x)
    return [*got[:-1], last._replace(state=st, stats=stats, diag=diag,
                                     bounds=rows)]


@pytest.mark.parametrize("fault", [
    None, "lost", "overflow", "nan", "rows_differ", "step_counter",
    "narrow", "span", "imbalance", "frozen", "outside"])
def test_the_soak_check_catches_each_fault(fault):
    """The clean run passes; each broken invariant is named, and alone."""
    cfg = default_config(**SOAK)
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    got, chunks = _clean_run(cfg, st)
    if fault is not None:
        got = _break(fault, got, cfg)
    rows, bad = soak.check(cfg, 4, st, got, chunks, None, 2.0)
    assert [r["step"] for r in rows] == [25, 50, 75]
    assert len(bad) == (fault is not None), bad
