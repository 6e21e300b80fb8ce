"""The ball spawn (`harness.spawn`, "shape": "ball"): the blowup scene's
start, drawn from the seed, and a whole run from it on the CPU.

The run is `harness.run` without the look for a card, with the 1M cell's
own limits, on 2,048 particles in a ball at the centre of that cell's box,
at the 1M blowup's spawn density (1M in a ball of radius wall / 4 at wall
4.64: ~153,000 particles a unit volume, ~1.9x the dam column's), in a
12-step segment: the sound program comes out correct, and the program with
half of its particles left unstepped does not."""

import math

import pytest
import torch

from pbfbench import harness
from pbfbench.tests.test_pbfbench_faults import (CELLS, _half_left_out,
                                                 _plant)

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5
N = 8192
BALL = {"shape": "ball", "centre": [0.5, 0.4, 0.6], "radius": 0.25}
WALL = 4.64
# the 1M blowup's spawn density: 1e6 / (4/3 pi (4.64 / 4)^3)
DENSITY = 1e6 / (4 / 3 * math.pi * (WALL / 4) ** 3)


def _ball(n: int = N, spawn: dict = BALL, seed: int = SEED):
    return harness.spawn({"spawn": spawn, "n": n, "wall": WALL}, seed, CPU)


def _radii(x: torch.Tensor) -> torch.Tensor:
    """Each point's distance from the centre, in units of R, in float64."""
    centre = torch.tensor(BALL["centre"], dtype=torch.float64) * WALL
    return (x.double() - centre).norm(dim=1) / (BALL["radius"] * WALL)


def test_a_seed_gives_the_same_ball_twice():
    x = _ball()[0]
    assert torch.equal(x, _ball()[0])
    assert not torch.equal(x, _ball(seed=6)[0])


def test_the_ball_is_its_recipe_bit_for_bit():
    """A normalised standard normal direction, then R u^(1/3), both from
    the seed's one generator, in that order."""
    gen = torch.Generator().manual_seed(SEED)
    d = torch.randn((N, 3), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    r = BALL["radius"] * torch.rand((N, 1), generator=gen) ** (1 / 3)
    assert torch.equal(_ball()[0],
                       (torch.tensor(BALL["centre"]) + d * r) * WALL)


def test_the_ball_holds_every_point():
    """Within R of the centre, to float32 rounding of a coordinate."""
    r = _radii(_ball()[0])
    assert float(r.max()) <= 1 + 8 * torch.finfo(torch.float32).eps
    assert float(r.max()) > 0.99


def test_the_ball_is_uniform_in_volume():
    """The mean distance within four standard errors of 3/4 R, the share
    inside R/2 of 1/8, and the centre of mass of the centre."""
    x, r = _ball()[0], _radii(_ball()[0])
    sd_r = math.sqrt(3 / 5 - (3 / 4) ** 2)
    assert abs(float(r.mean()) - 0.75) < 4 * sd_r / math.sqrt(N)
    inner = float((r < 0.5).double().mean())
    assert abs(inner - 1 / 8) < 4 * math.sqrt(1 / 8 * 7 / 8 / N)
    offset = (x.double().mean(0) / WALL - torch.tensor(BALL["centre"],
                                                       dtype=torch.float64))
    sd_axis = BALL["radius"] / math.sqrt(5)
    assert bool((offset.abs() < 4 * sd_axis / math.sqrt(N)).all())


@pytest.mark.parametrize("spawn", [BALL, {"shape": "box", "lo": [0.0] * 3,
                                          "hi": [0.25, 1.0, 0.5]}],
                         ids=["ball", "box"])
def test_a_spawn_is_float32_at_rest_with_ids_and_step_0(spawn):
    x, v, ids, step = _ball(spawn=spawn)
    assert x.dtype == v.dtype == torch.float32 and x.shape == (N, 3)
    assert x.is_contiguous() and not v.any()
    assert torch.equal(ids, torch.arange(N, dtype=torch.int32))
    assert step.dtype == torch.int32 and int(step) == 0


@pytest.mark.parametrize("lo, hi", [([0.0, 0.0, 0.0], [0.25, 1.0, 0.5]),
                                    ([0.7] * 3, [0.995] * 3)])
def test_the_box_is_its_formula_bit_for_bit(lo, hi):
    """The box of every cell so far: one draw of n x 3 uniforms, so that
    each seed spawns the same points as before the ball."""
    gen = torch.Generator().manual_seed(SEED)
    u = torch.rand((N, 3), generator=gen)
    want = (torch.tensor(lo) + u * (torch.tensor(hi) - torch.tensor(lo))) * WALL
    got = _ball(spawn={"shape": "box", "lo": lo, "hi": hi})[0]
    assert torch.equal(got, want)


def _small_ball(n: int = 2048) -> dict:
    """n particles at the 1M blowup's density, at the 1M box's centre."""
    radius = (3 * n / (4 * math.pi * DENSITY)) ** (1 / 3)
    assert harness.find_cell("dam1m.rollout").config["wall"] == WALL
    return {"n": n, "spawn": {"shape": "ball", "centre": [0.5] * 3,
                              "radius": radius / WALL}}


def _run() -> dict:
    return harness.run("dam1m.rollout", 2 ** 31 + 13, 0.01, False,
                       device="cpu", config=_small_ball(),
                       traffic=CELLS["dam1m.rollout"])


def test_a_run_from_the_ball_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_a_run_from_the_ball_with_half_unstepped_is_not_correct(
        monkeypatch):
    _plant(monkeypatch, _half_left_out)
    r = _run()
    assert not r["correct"]
    failed = {k for k, c in r["checks"].items()
              if not c["value"] <= c["limit"]}
    assert failed & {"x_gap", "x_gap_median", "order_mismatch"}
