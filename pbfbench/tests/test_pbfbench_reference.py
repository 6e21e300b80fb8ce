"""The plain reference step against the port's own CPU step.

At 2,048 particles in the 80k box's number density, three steps: first the
three steps from the spawn, then three steps after 30 from it. Both sides
start from the same state each step (the port's), so only the arithmetic
of one step separates them: the cell sort is the same permutation, and the
median particle's position agrees to a few float32 units in the last place.
In the first steps from the spawn a pair outside the 27 cells around a
particle's predicted cell comes within h during the solve, and the port's
windows count it where the reference's cells do not: the widest gap there
is that choice (pbfbench/harness.py `compare`); after 30 steps it is the
arithmetic's too."""

import pytest
import torch

from pbfbench import harness
from pbfbench.reference import pbf

N, WALL = 2048, 0.59


def _config():
    cell = harness.find_cell("dam80k.frames")
    return {**cell.config, "n": N, "wall": WALL}


def _port_steps(conf, state, count):
    stepper = harness.Program(conf, 1, torch.device("cpu"))
    out = []
    for _ in range(count):
        nxt, stats = stepper(state, 1)
        out.append((state, nxt, stats))
        state = nxt
    return out


@pytest.mark.parametrize("skip, widest", [(0, 1e-3), (30, 1e-6)])
def test_the_reference_steps_as_the_port_does(skip, widest):
    conf = _config()
    state = harness.spawn(conf, 11, torch.device("cpu"))
    if skip:
        state = _port_steps(conf, state, skip)[-1][1]
    for s, nxt, stats in _port_steps(conf, state, 3):
        ref = pbf.step(conf, s[0], s[1], s[2])
        assert torch.equal(ref["ids"], nxt[2])
        assert stats.tolist() == [0, 0, int(ref["nonfinite"])] == [0, 0, 0]
        gap = (ref["x"] - nxt[0]).abs().amax(1)
        assert float(gap.median()) < 1e-7
        assert float(gap.max()) < widest
        vgap = (ref["v"] - nxt[1]).abs().amax(1)
        assert float(vgap.max()) < widest / conf["dt"]


def test_the_reference_keeps_the_box_and_flags_a_nan():
    conf = _config()
    x, v, ids, _ = harness.spawn(conf, 5, torch.device("cpu"))
    v = v + torch.tensor([-40.0, 30.0, 20.0])
    ref = pbf.step(conf, x, v, ids)
    assert float(ref["x"].min()) >= 0.0 and float(ref["x"].max()) <= WALL
    assert not ref["nonfinite"]
    x[3, 1] = float("nan")
    assert pbf.step(conf, x, v, ids)["nonfinite"]
