"""The rank path of the harness (pbfbench/ranks.py) on two gloo ranks on the
CPU, with the four-card cell's own limits: the rest of a run without the
look for a card, at 2,048 particles (a cube at the cells' number density
0.005 from the far walls of the cell's own box, as tests/test_pbfbench_faults
places it), the compact tier from step 4, 8-step segments.

The sound program comes out correct, with its rate and both ranks counted.
Each planted fault comes out not correct: one rank's step returning its
particles unstepped; half of the particles left unstepped; the ghost
exchange between the ranks left out; one particle's answer altered where it
is produced; a collected state missing a particle. So does the control, the
program's own tensor-core path. A fault is planted in each rank's process
after the set-up, by a function of this module, which a spawned rank
imports by name.
"""

import pytest
import torch

from pbfbench import control, harness, ranks

CELL = "dam1m_d4.rollout"
SEED = 2 ** 31 + 23
N = 2048
SIDE = (N / 80000) ** (1 / 3)
GAP = 0.005
TRAFFIC = {"segment_steps": 8, "steps_per_call": 8, "gap_from": 4,
           "check_phases": 4}


def _small() -> dict:
    conf = harness.find_cell(CELL).config
    hi = 1.0 - GAP / conf["wall"]
    lo = hi - SIDE / conf["wall"]
    return {"n": N, "spawn": {"shape": "box", "lo": [lo] * 3,
                              "hi": [hi] * 3},
            "parallel": {**conf["parallel"], "ranks": 2, "retier_at": 4}}


def _failed(result: dict) -> set:
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


# ---------------------------------------------------------------------------
# the faults, planted in a rank's process: each takes the rank and returns
# the undo
# ---------------------------------------------------------------------------

def _wrap(name, wrapper):
    from pdb_sph_tpu_torch.parallel import sharded

    sound = getattr(sharded, name)
    setattr(sharded, name, wrapper(sound))
    return lambda: setattr(sharded, name, sound)


def unstepped_rank(rank: int):
    """Rank 1's step leaves its particles where the step found them."""
    if rank != 1:
        return lambda: None
    return _wrap("finalize", lambda sound: lambda cfg, p, last: (
        last.clone(), torch.zeros_like(last)))


def _stepped(fix):
    """A sharded step whose output (x, v, ids) `fix(cfg, x_in, v_in,
    ids_in, x, v, ids)` changes."""
    def wrapper(sound):
        def step(cfg, pcfg, backend, group, work, x, v, ids, brow):
            out = sound(cfg, pcfg, backend, group, work, x, v, ids, brow)
            return (*fix(cfg, x, v, ids, *out[:3]), *out[3:])
        return step
    return wrapper


def _half(cfg, x_in, v_in, ids_in, x, v, ids):
    """The particles of the upper half of the ids that stayed on their
    rank keep their state."""
    row = torch.full((cfg.n,), -1, dtype=torch.long)
    live = ids_in >= 0
    row[ids_in[live].long()] = torch.nonzero(live)[:, 0]
    at = row[ids.long().clamp_min(0)]
    keep = (ids >= cfg.n // 2) & (at >= 0)
    x, v = x.clone(), v.clone()
    x[keep], v[keep] = x_in[at[keep]], v_in[at[keep]]
    return x, v, ids


def half_unstepped(rank: int):
    return _wrap("_shard_step", _stepped(_half))


def _moved(cfg, x_in, v_in, ids_in, x, v, ids):
    """Particle 7's position off by 1e-2 (10 % of h) in every step."""
    x = x.clone()
    x[ids == 7, 1] += 1e-2
    return x, v, ids


def altered(rank: int):
    return _wrap("_shard_step", _stepped(_moved))


def no_exchange(rank: int):
    """The ghosts that the neighbours send never arrive: every ghost slot
    is empty."""
    from pdb_sph_tpu_torch.parallel import sharded

    def wrapper(sound):
        def ghost_exchange(pcfg, group, left, right):
            exchange, over = sound(pcfg, group, left, right)

            def empty(p_now):
                gp, gok = exchange(p_now)
                return (torch.full_like(gp, sharded.SENTINEL),
                        torch.zeros_like(gok))
            return empty, over
        return ghost_exchange
    return _wrap("_ghost_exchange", wrapper)


def missing_particle(rank: int):
    """A collected state lacks its last particle."""
    def wrapper(sound):
        def collect(sst, group=None):
            st = sound(sst, group)
            return st._replace(x=st.x[:-1], v=st.v[:-1], ids=st.ids[:-1])
        return collect
    return _wrap("collect", wrapper)


FAULTS = {"unstepped_rank": {"x_gap"},
          "half_unstepped": {"x_gap", "x_gap_median"},
          "altered": {"x_gap"},
          "no_exchange": {"x_gap"},
          "missing_particle": {"id_mismatch"}}


@pytest.fixture(scope="module")
def faulty():
    """Each fault's run and the control's, one after another on one pair
    of ranks."""
    items = [ranks.Item(SEED, fault=f"{__name__}:{f}") for f in FAULTS]
    items.append(ranks.Item(SEED, geometry=control.CONTROL_GEOMETRY))
    results = ranks.run_items(CELL, items, 0.01, False, device="cpu",
                              config=_small(), traffic=TRAFFIC)
    return dict(zip([*FAULTS, "control"], results))


def test_the_sound_program_is_correct_on_two_ranks():
    r = ranks.run(CELL, SEED, 0.01, True, device="cpu", config=_small(),
                  traffic=TRAFFIC)
    assert r["correct"], r["checks"]
    assert r["checks"]["replay_mismatch"]["value"] == 0
    assert "order_mismatch" not in r["checks"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert r["device"]["count"] == 2
    assert r["device"]["window_s"] > 0
    # the CPU's trace has no device activity: no per-layer metric
    assert r["metrics"] == {}
    h = harness.find_cell(CELL)
    assert "particle_steps_per_s.d4" in [
        e["name"] for e in harness.metrics_of(h, "end_to_end")]


def test_the_rate_and_the_set_up_are_read():
    r = harness.run(CELL, SEED + 1, 0.01, False, device="cpu",
                    config=_small(), traffic=TRAFFIC)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2
    rate = r["metrics"]["particle_steps_per_s.d4"]["value"]
    assert rate > 0 and r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(faulty, fault):
    r, _ = faulty[fault]
    assert not r["correct"]
    assert _failed(r) & FAULTS[fault], r["checks"]


def test_the_control_is_not_correct_on_the_ranks(faulty):
    """The program's tensor-core forms read above the limit of the median
    particle's gap."""
    r, head = faulty["control"]
    assert head["control"] and not r["correct"]
    assert "x_gap_median" in _failed(r), r["checks"]
