"""The two-tier sharded flow of the port on gloo ranks on the CPU.

The JAX package sizes a multi-device run twice: the spawn tier
(`ParallelConfig.create`, slack for the collapse to come) and, once the
fluid has settled, the compact tier (`ParallelConfig.compact`: every buffer
re-sized from the current state at 1.1x). Here: the compact sizing against
JAX's on the same numpy states; the whole flow of `dryrun_multichip`
(__graft_entry__.py:34-125: 12 spawn-tier steps, collect -> compact ->
distribute, 8 compact-tier steps) through `launch.rollout_ranks` on D = 2
and D = 4 gloo ranks, on both backends, against the port's single-device
step; and the two tiers from one collected state, which differ in their
padding only: the same local set, the same plans, the same bits.

A spawned rank imports this module to find its rank function; the patch it
needs, it makes itself.
"""

import dataclasses
import json
import multiprocessing
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.parallel import sharded as js
from pdb_sph_tpu_torch import default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.parallel import launch, sharded

torch.set_num_threads(1)

RANK_TIMEOUT_S = 240.0
# dryrun_multichip's shape: h = 0.05 doubles the z-rows of the small box,
# so 8 slabs fit inside the dam's spawn extent
DRYRUN = dict(n=1024, h=0.05, max_occupied_cells=2048, cell_capacity=128)
# the cell backend's plain passes cost max_occupied_cells x 27 x
# cell_capacity^2 a pass whatever the occupancy (~1 s a step at 1024 x 16
# here): a table of 1024 x 8 holds the 20 steps from the spawn (its densest
# cell holds 6) at a cost the tier-1 run can carry. The window backend has
# no table and runs at DRYRUN itself.
CELL_TABLE = dict(max_occupied_cells=1024, cell_capacity=8, block=8)
SPAWN_STEPS, COMPACT_STEPS = 12, 8
# the dryrun's long-horizon discriminator (__graft_entry__.py:85-99)
POP_MAX_DEV, POP_TOL, POP_FRAC = 5e-2, 2e-5, 0.05


def _cfg(backend):
    return default_config(**{**DRYRUN,
                             **(CELL_TABLE if backend == "cell" else {})})


@pytest.fixture(scope="module")
def references():
    """Per backend: the config, the spawn and the single-device Stepper's
    positions in id order after SPAWN_STEPS + COMPACT_STEPS steps."""
    out = {}
    for backend in ("window", "cell"):
        cfg = _cfg(backend)
        st = spawn(cfg, "dam_break", seed=0, device="cpu")
        ref = st
        stepper = tstep.make_step(cfg, backend, device="cpu")
        for _ in range(SPAWN_STEPS + COMPACT_STEPS):
            ref, stats = stepper.step(ref, with_stats=True)
            assert stats.tolist() == [0, 0, 0]
        out[backend] = (cfg, st, ref.x[torch.argsort(ref.ids.long())])
    return out


@pytest.mark.parametrize("backend", ["window", "cell"])
@pytest.mark.parametrize("D", [2, 4])
def test_two_tier_flow_matches_the_single_device_step(references, D,
                                                      backend):
    cfg, st, want = references[backend]
    (mid, s1, d1, _, _, _), (got, s2, d2, _, g2, _) = launch.rollout_ranks(
        cfg, st, D, [SPAWN_STEPS, COMPACT_STEPS], backend,
        devices=["cpu"] * D, retier=1, timeout_s=RANK_TIMEOUT_S)[0]
    spawn_tier = sharded.ParallelConfig.create(cfg, D, state=st)
    compact = sharded.ParallelConfig.compact(cfg, D, state=mid,
                                             prior=spawn_tier)
    assert compact.capacity <= spawn_tier.capacity
    assert compact.ghost_capacity <= spawn_tier.ghost_capacity
    for stats, diag in ((s1, d1), (s2, d2)):
        assert stats[:, 1:].sum() == 0, stats.tolist()
        assert stats[:, 0].sum() == cfg.n and diag[:, 1:].sum() == 0
    assert g2[:, 4].sum() == 0
    assert torch.equal(got.ids, torch.arange(cfg.n, dtype=torch.int32))
    assert torch.isfinite(got.x).all()
    dev = (got.x - want).abs()
    assert float(dev.max()) < POP_MAX_DEV
    assert float((dev > POP_TOL).float().mean()) < POP_FRAC
    act = s2[:, 0].double()
    assert act.min() >= 0.5 * act.mean(), act.tolist()


@pytest.fixture(scope="module")
def numpy_states():
    """The dryrun's spawn and the port's window rollout of it 60 steps on,
    as numpy (x, v, ids)."""
    cfg = _cfg("window")
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    settled = tstep.make_rollout(cfg, "window", 60, device="cpu")(st)
    return {name: tuple(t.numpy() for t in s[:3])
            for name, s in (("spawn", st), ("settled", settled))}


@pytest.mark.parametrize("state", ["spawn", "settled"])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_compact_tier_equals_jax(numpy_states, D, state):
    """ParallelConfig.compact (with create's tier as its prior) of both
    packages on the same numpy state."""
    jcfg = jpbf.default_config(**DRYRUN)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    x, v, ids = numpy_states[state]
    jst = jpbf.spawn(jcfg, "dam_break", seed=0)._replace(
        x=jnp.asarray(x), v=jnp.asarray(v), ids=jnp.asarray(ids))
    st = interop.state_from_numpy(x, v, ids, 0, "cpu")
    prior = sharded.ParallelConfig.create(cfg, D, state=st)
    jprior = js.ParallelConfig.create(jcfg, D, state=jst)
    assert dataclasses.asdict(prior) == dataclasses.asdict(jprior)
    mine = sharded.ParallelConfig.compact(cfg, D, st, prior=prior)
    theirs = js.ParallelConfig.compact(jcfg, D, jst, prior=jprior)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.capacity <= prior.capacity


def _tier_plans_rank(group, device, workdir, cfg, arrays, backend):
    """SPAWN_STEPS steps on the spawn tier, then from the collected state
    COMPACT_STEPS steps on each tier (create and compact of that state):
    the final states, and on the window backend the first step's local set
    and plans on each tier (recorded by a wrapper of
    sharded._window_plans)."""
    state = interop.state_from_numpy(*arrays, 0, "cpu")
    first = sharded.ParallelConfig.create(cfg, group.size, state=state)
    sst = sharded.distribute(cfg, first, state, group, device)
    sst, _, _ = sharded.make_sharded_rollout(cfg, first, group, backend,
                                             SPAWN_STEPS, device)(sst)
    st = sharded.collect(sst, group)
    tiers = {"spawn": sharded.ParallelConfig.create(cfg, group.size,
                                                    state=st)}
    tiers["compact"] = sharded.ParallelConfig.compact(
        cfg, group.size, state=st, prior=tiers["spawn"])
    real, seen = sharded._window_plans, []

    def recording(cfg_, cid, z_bounds):
        out = real(cfg_, cid, z_bounds)
        seen.append((cid, *out))
        return out

    sharded._window_plans = recording
    res = {"caps": {}, "final": {}, "stats": {}, "plans": {}}
    for name, pc in tiers.items():
        seen.clear()
        roll = sharded.make_sharded_rollout(cfg, pc, group, backend,
                                            COMPACT_STEPS, device)
        s, stats, _ = roll(sharded.distribute(cfg, pc, st, group, device))
        got = sharded.collect(s, group)
        res["caps"][name] = [pc.capacity, pc.ghost_capacity,
                             pc.mig_capacity]
        res["final"][name] = [t.tolist() for t in got[:3]]
        res["stats"][name] = stats.tolist()
        if seen:
            cid, order, plan, plan_d, plan_p = seen[0]
            res["plans"][name] = {
                "rows": int(cid.shape[0]),
                "valid": int((cid < cfg.num_nb_cells).sum()),
                "sorted_cid": cid[order].tolist(),
                **{k: p.ranges.tolist() for k, p in (
                    ("plan", plan), ("plan_d", plan_d), ("plan_p", plan_p))}}
    with open(os.path.join(workdir, f"rank{group.rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.mark.parametrize("backend", ["window", "cell"])
def test_spawn_and_compact_tiers_agree_from_one_state(tmp_path, backend):
    """From one collected state, the two tiers hold every valid slot in
    the same place of the sorted local set and differ in the padding
    after it only: the plans of the chunks with a valid row are the same
    ranges, no range reaches into the padding (a mixed chunk's windows
    come from its real rows), and COMPACT_STEPS steps on each tier end in
    the same bits, as the card check holds them."""
    cfg = _cfg(backend)
    arrays = tuple(t.numpy() for t in
                   spawn(cfg, "dam_break", seed=0, device="cpu")[:3])
    launch.run(_tier_plans_rank, 2, ["cpu"] * 2, timeout_s=RANK_TIMEOUT_S,
               workdir=str(tmp_path), args=(cfg, arrays, backend))
    assert not multiprocessing.active_children()
    own = cfg.geom.own
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        spawn_caps, compact_caps = res["caps"]["spawn"], res["caps"][
            "compact"]
        assert compact_caps[0] < spawn_caps[0], res["caps"]
        assert res["final"]["spawn"] == res["final"]["compact"]
        for stats in res["stats"].values():
            assert sum(row[0] for row in stats) == cfg.n
            assert not any(any(row[1:]) for row in stats)
        if backend != "window":
            continue
        a, b = res["plans"]["spawn"], res["plans"]["compact"]
        assert a["valid"] == b["valid"] and a["rows"] > b["rows"]
        valid = a["valid"]
        assert a["sorted_cid"][:valid] == b["sorted_cid"][:valid]
        chunks = -(-valid // own)
        for key in ("plan", "plan_d", "plan_p"):
            ra, rb = np.array(a[key]), np.array(b[key])
            np.testing.assert_array_equal(ra[:chunks], rb[:chunks])
            for ranges in (ra, rb):
                # no window reaches a padding row; the chunks of padding
                # alone have none
                assert ranges[..., 1].max() <= valid
                assert not (ranges[chunks:, :, 1]
                            - ranges[chunks:, :, 0]).any()


class _Graph:
    """A graph that replays the captured body eagerly and records its
    reset."""

    def __init__(self, replay):
        self.replay, self.was_reset = replay, False

    def reset(self):
        self.was_reset = True


class _EagerCapture(tstep.CapturedStep):
    def __init__(self, body, state, acc):
        self.state = tuple(t.clone() for t in state)
        self.acc = tuple(t.clone() for t in acc)
        self.launches = {}
        self.graph = _Graph(lambda: body(self.state, self.acc))


def test_a_released_rollout_frees_its_graph_buffers_and_scratch(
        monkeypatch):
    """What a re-tier frees before the next tier allocates: the graph
    (reset), its static state, the stepper's buffers and scratch."""
    cfg = _cfg("window")
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    monkeypatch.setattr(sharded, "CapturedStep", _EagerCapture)
    roll = sharded.make_sharded_rollout(cfg, pcfg, None, "window", 2, "cpu")
    roll.graphed = True
    roll(sharded.distribute(cfg, pcfg, st, device="cpu"))
    captured = roll.captured
    assert roll.stepper.work is not None and captured.state
    roll.release()
    assert captured.graph.was_reset and captured.state == ()
    assert roll.captured is None and roll.stepper.work is None


def test_the_move_rule_keeps_balancing_on_the_compact_tier():
    """JAX keeps a recipient under capacity - capacity // 8; on the compact
    tier (1.1x the worst slab) of the 1M multi-device row that lies under
    every rank's load, and no boundary moves. The port's rule has no
    recipient limit (sharded._move_bounds): a profitable move is taken,
    and it leaves the recipient no heavier than the donor was."""
    D = 4
    cfg = default_config(n=1_000_000, wall=4.64, grid_width=40)
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    compact = sharded.ParallelConfig.compact(cfg, D, state=st)
    b = sharded.initial_bounds(cfg, D, state=st)
    load = np.bincount(np.searchsorted(
        b[1:-1], sharded._np_zxkey(cfg, st.x.numpy()), side="right"),
        minlength=D)
    jax_limit = compact.capacity - compact.capacity // 8
    assert jax_limit < load.min() <= load.max() <= compact.capacity

    # boundary 1 (eligible at an odd step): rank 0 is 30 heavier than rank
    # 1, and only its last one-key strip (10 particles) is small enough to
    # donate
    brow = torch.tensor([1, *b], dtype=torch.int32)
    L = int(load.max())
    R, strips = L - 30, [4000, 400, 10]
    g = torch.zeros((D, 1 + 2 * len(sharded._move_scales(cfg))),
                    dtype=torch.int32)
    g[:, 0] = torch.tensor([L, R, L, L])
    g[:, 1::2] = torch.tensor(strips)
    g[:, 2::2] = torch.tensor(strips)
    # JAX's recipient term refuses even the smallest strip
    assert R + strips[-1] > jax_limit
    moved = sharded._move_bounds(cfg, compact, brow, g)
    want = brow[1:].clone()
    want[1] -= 1
    assert moved[1:].tolist() == want.tolist()
    assert R + strips[-1] <= L
