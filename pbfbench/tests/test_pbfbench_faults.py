"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (harness.run without the
look for a card), with the cell's own limits, at 2,048 particles and a
12-step segment: a cube at the cells' number density in the far corner of
the cell's own box, 0.005 from its walls, so that the coordinates are as
large as the cell's (the tensor-core forms' error grows with |p|^2) and
particles bounce off the walls in the last steps: first the sound program,
then the program with one fault planted in its step (a step that returns
its state unchanged; half of the particles left unstepped; one particle's
answer altered where it is produced; the velocity of each particle that
bounces off a wall left undamped), then the control in the program's
place: the program's own lower-precision path, every tensor-core switch
on. A single card has no exchange between chips to leave out."""

import pytest
import torch

from pbfbench import control, harness
from pdb_sph_tpu_torch.core import step as core_step

SIDE = (2048 / 80000) ** (1 / 3)
# the cube's distance from the three far walls, so that particles bounce
# within the segment
GAP = 0.005


def _small(cell: str) -> dict:
    wall = harness.find_cell(cell).config["wall"]
    hi = 1.0 - GAP / wall
    lo = hi - SIDE / wall
    return {"n": 2048, "spawn": {"shape": "box", "lo": [lo] * 3,
                                 "hi": [hi] * 3}}


CELLS = {"dam80k.frames": {"segment_steps": 12, "gap_from": 6,
                           "check_phases": 6},
         "dam1m.rollout": {"segment_steps": 12, "steps_per_call": 12,
                           "gap_from": 6, "check_phases": 6}}


def _run(cell: str, seed: int = 2 ** 31 + 11) -> dict:
    return harness.run(cell, seed, 0.01, False, device="cpu",
                       config=_small(cell), traffic=CELLS[cell])


def _failed(result: dict) -> set:
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


def _plant(monkeypatch, broken):
    sound = core_step.Stepper.step

    def step(self, state, with_stats=False, mark=None):
        out, stats = sound(self, state, with_stats=True, mark=mark)
        out = broken(state, out)
        return (out, stats) if with_stats else out

    monkeypatch.setattr(core_step.Stepper, "step", step)


def _unchanged(state, out):
    return state._replace(step=state.step + 1)


def _half_left_out(state, out):
    """The upper half of the particles (by id) keep their state."""
    x, v = out.x.clone(), out.v.clone()
    back = torch.empty_like(state.ids, dtype=torch.long)
    back[state.ids.long()] = torch.arange(state.ids.numel())
    keep = out.ids.long() >= out.ids.numel() // 2
    x[keep] = state.x[back[out.ids.long()[keep]]]
    v[keep] = state.v[back[out.ids.long()[keep]]]
    return out._replace(x=x, v=v)


def _altered(state, out):
    """One particle's position off by 1e-2 (10 % of h) in every step."""
    x = out.x.clone()
    x[out.ids == 7, 1] += 1e-2
    return out._replace(x=x)


def _undamped_bounce(monkeypatch):
    """finalize leaves the velocity of every particle that a wall bounces
    undamped (the reflection is kept); positions and every other particle
    are as the sound program writes them."""
    sound = core_step.finalize

    def finalize(cfg, p, last):
        x, v = sound(cfg, p, last)
        bounced = (v != (p - last) / cfg.dt).any(dim=1)
        v = torch.where(bounced[:, None], v / cfg.collision_damp, v)
        return x, v

    monkeypatch.setattr(core_step, "finalize", finalize)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_sound_program_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"]
    assert _failed(r) & {"x_gap", "x_gap_median", "order_mismatch"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    """The program's bf16 hi/lo tensor-core forms read above the limit of
    the median particle's gap on every seed tried."""
    limit = harness.find_cell(cell).limits["x_gap_median"]["limit"]
    for r in control.readings(cell, [1, 2, 3], control.CONTROL_GEOMETRY,
                              "cpu", config=_small(cell),
                              traffic=CELLS[cell]):
        assert r["numbers"]["x_gap_median"] > limit, r


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_wrong_bounce_fails_the_widest_velocity_gap(monkeypatch, cell):
    """Only the particles that bounce are wrong, and only in velocity: the
    compared steps start from the program's own state, so neither position
    number nor the median velocity sees it."""
    _undamped_bounce(monkeypatch)
    r = _run(cell)
    assert not r["correct"]
    assert _failed(r) == {"v_gap"}
