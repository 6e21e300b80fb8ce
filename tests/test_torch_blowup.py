"""The blowup from its ball against the benchmark's plain references, on
the CPU.

The benchmark's cell `blowup1m.rollout` checks the port against
`pbfbench/reference/pbf_windows.py`, which sums over the port's pair set
(the pairs within h among the nine cell ranges of each particle's own-row
chunk) where `pbf.py` takes the CUDA source's 27 cells around each
particle. In the explosion's first steps the solve brings pairs within h
from beyond the 27 cells, which the port counts and `pbf.py` does not.
Here, on a 4,096-particle ball at the 1M blowup's spawn density:

- the port's plain step agrees with `pbf_windows` at phases 0, 1, 2 and 8,
  and sits at least ten times closer to it than to `pbf.py`;
- the two references agree on a dam state where no pair within h leaves
  the 27 cells;
- the control of the benchmark (every tensor-core switch on, the pair sums
  in bf16 hi/lo products) fails those tolerances on the same ball.
"""

import json
import math

import numpy as np
import pytest
import torch

from pbfbench import harness, neighbours
from pbfbench.control import CONTROL_GEOMETRY
from pbfbench.reference import pbf, pbf_windows

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONFIGS = harness.HERE / "configs"
N = 4096
SEED = 2 ** 31 + 7
PHASES = [0, 1, 2, 8]


def _config(name: str, n: int, wall: float) -> dict:
    return {**json.loads((CONFIGS / f"{name}.json").read_text()), "n": n,
            "wall": wall}


# the 1M blowup's ball at its own number density: the box scaled by
# (N / 1M)^(1/3), the ball's radius wall / 4 with it
BALL = _config("blowup_1m", N, 4.64 * (N / 1e6) ** (1 / 3))
# the 80k dam break at its own number density
DAM = _config("dam_break_80k", N, 2.0 * (N / 8e4) ** (1 / 3))

# one float32 unit of a coordinate at the box's centre, where the ball and
# its median particle lie; a velocity is a position's change over dt, so
# one unit of a position makes X_UNIT / dt of a velocity
X_UNIT = float(np.spacing(np.float32(BALL["wall"] / 2)))
V_UNIT = X_UNIT / BALL["dt"]
# the widest gaps of the port from pbf_windows sit at least this many
# times under its widest gaps from pbf.py on the same states: a wider
# pair set, not the arithmetic, is what sets the port apart from pbf.py
SEPARATION = 10.0


def _steps(config: dict, geometry: dict | None = None) -> list:
    """The port's plain steps from the seed's spawn at PHASES: [(phase,
    state, next state, counters)], as the benchmark's check takes them."""
    program = harness.Program(config, 1, CPU, geometry)
    mix = harness.Traffic(segment_steps=PHASES[-1] + 1, steps_per_call=1,
                          read_back=("counters",), check_phases=len(PHASES),
                          gap_from=0)
    start = harness.spawn(config, SEED, CPU)
    steps, _, _ = harness.redrive(program, start, mix, PHASES, [])
    program.release()
    return steps


@pytest.fixture(scope="module")
def sound():
    return _steps(BALL)


@pytest.fixture(scope="module")
def control():
    return _steps(BALL, CONTROL_GEOMETRY)


def _missed(steps: list) -> list[str]:
    """The tolerances that the port's `steps` miss against pbf_windows."""
    got = harness.compare({**BALL, "reference": "pbf_windows"}, steps, 0)
    base = harness.compare({**BALL, "reference": "pbf"}, steps, 0)
    missed = [k for k in ("order_mismatch", "counter_mismatch") if got[k]]
    if got["x_gap_median"] > X_UNIT:
        missed.append("x_gap_median")
    if got["v_gap_median"] > V_UNIT:
        missed.append("v_gap_median")
    for k in ("x_gap", "v_gap"):
        if not SEPARATION * got[k] <= base[k]:
            missed.append(k)
    return missed


def test_the_steps_from_the_ball_are_the_windows_reference(sound):
    """Ids in the same order, the same counters, both medians within one
    float32 unit, and the widest gaps away from the walls at least ten
    times under pbf.py's on the same states."""
    assert [s[0] for s in sound] == PHASES
    assert _missed(sound) == []


def test_pbf_departs_from_the_port_in_the_explosion(sound):
    """The departure that pbf_windows accounts for is there at this size:
    pbf.py's widest gap is far above a float32 unit of the box, and the
    two references differ only while pairs leave the 27 cells."""
    base = harness.compare({**BALL, "reference": "pbf"}, sound[:1], 0)
    assert base["x_gap"] > 100 * X_UNIT
    assert _outside_27(BALL, *sound[0][1][:2]) > 0


def _outside_27(config: dict, x: torch.Tensor, v: torch.Tensor) -> int:
    """Pairs of pbf_windows's set at the iterates of its step from (x, v)
    whose partner's predicted cell lies outside the 27 cells around the
    particle's."""
    k = pbf.Constants(config)
    own = config["geometry"]["own"]
    p = pbf.predict(k, x, v)
    cell, order = torch.sort(pbf.cell_of(k, p), stable=True)
    lo, hi = pbf_windows.windows(k, cell, own)
    q, far = p[order], 0
    for _ in range(k.iters):
        def near(q=q):
            return pbf_windows.pairs(k, cell, lo, hi, own, q)
        for i, j, _, _ in near():
            a = torch.stack(neighbours.cell_coords(cell[i], k.width))
            b = torch.stack(neighbours.cell_coords(cell[j], k.width))
            far += int(((a - b).abs() > 1).any(dim=0).sum())
        q = pbf_windows._project(k, near, q, pbf_windows._lambda(k, near, q))
    return far


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap of a from b in float32 units of a."""
    unit = torch.nextafter(a.abs(), torch.tensor(math.inf)) - a.abs()
    return float(((a - b).abs() / unit).max())


def test_the_references_agree_where_no_pair_leaves_the_27_cells():
    """On the 80k dam's spawn at this size, after ten of the port's steps,
    no pair within h at an iterate leaves the 27 cells, and pbf_windows's
    step is pbf.py's within one float32 unit of every coordinate (its
    sums run over the same pairs in another order, each in float64 and
    rounded once)."""
    program = harness.Program(DAM, 10, CPU)
    state, _ = program(harness.spawn(DAM, SEED, CPU))
    program.release()
    assert _outside_27(DAM, state[0], state[1]) == 0
    a = pbf.step(DAM, *state[:3])
    b = pbf_windows.step(DAM, *state[:3])
    assert torch.equal(a["ids"], b["ids"])
    assert a["nonfinite"] == b["nonfinite"] is False
    assert torch.equal(a["at_wall"], b["at_wall"])
    assert _ulps(a["x"], b["x"]) <= 1 and _ulps(a["v"], b["v"]) <= 1


def test_the_control_misses_those_tolerances(control):
    """The program with every tensor-core switch on moves every particle
    off pbf_windows by far more than a float32 unit."""
    missed = _missed(control)
    assert {"x_gap_median", "v_gap_median"} <= set(missed), missed
