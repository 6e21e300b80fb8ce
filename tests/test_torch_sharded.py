"""The port's sharded decomposition (`pdb_sph_tpu_torch.parallel`) on the
CPU.

The host-side numpy pieces, `_pack_rows`, the move rule and
`restrict_plan` are held against the JAX package directly (the move rule
under `jax.shard_map` on 4 of conftest's 8 fake CPU devices). The sharded
step itself is held against the port's single-device step, which the other
test files hold against JAX: D = 2 and D = 4 gloo ranks, one process each,
through `parallel.launch` (a file-store rendezvous in its own temporary
directory, a time limit of its own, no process left behind).
"""

import dataclasses
import multiprocessing
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.ops import pallas_pbf as jpp
from pdb_sph_tpu.parallel import sharded as js
from pdb_sph_tpu_torch import default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.geometry import KernelGeometry
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid
from pdb_sph_tpu_torch.parallel import launch, sharded

torch.set_num_threads(1)

# tests/test_sharded.py:55-56
X_RTOL, X_ATOL = 1e-4, 1e-5
V_RTOL, V_ATOL = 1e-3, 2e-3
STEPS = 3
RANK_TIMEOUT_S = 120.0
# the sharded density diagnostics against the single device's: rho sums
# the same pairs in another order (ghosts included), in float32
DENS_RTOL, DENS_ERR_ATOL = 1e-4, 1e-4


def _jax_pair(n, scene="dam_break", seed=0, **kw):
    jcfg = jpbf.default_config(n=n, **kw)
    st = jpbf.spawn(jcfg, scene, seed=seed)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, cfg, st, interop.state_from_numpy(st.x, st.v, st.ids,
                                                   st.step, "cpu")


# ---------------------------------------------------------------------------
# host-side numpy pieces against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,D,scene", [(2048, 2, "dam_break"),
                                       (2048, 4, "blowup"),
                                       (4096, 8, "dam_break")])
def test_bounds_and_capacities_equal_jax(n, D, scene):
    jcfg, cfg, jst, st = _jax_pair(n, scene)
    for kw in (dict(state=None), dict(state="s"),
               dict(state="s", rebalance=False, z_cells_hi=12)):
        a = dict(kw, state=jst if kw["state"] else None)
        b = dict(kw, state=st if kw["state"] else None)
        np.testing.assert_array_equal(sharded.initial_bounds(cfg, D, **b),
                                      js.initial_bounds(jcfg, D, **a))
    for d in (1, D):
        for kw in (dict(), dict(ghost_rows=2, slack=2.0, mig_slack=1.5)):
            assert dataclasses.asdict(sharded.ParallelConfig.create(
                cfg, d, state=st, **kw)) == dataclasses.asdict(
                    js.ParallelConfig.create(jcfg, d, state=jst, **kw))
        assert dataclasses.asdict(sharded.ParallelConfig.create(cfg, d)) \
            == dataclasses.asdict(js.ParallelConfig.create(jcfg, d))
    prior = sharded.ParallelConfig.create(cfg, D, state=st, rebalance=False)
    jprior = js.ParallelConfig.create(jcfg, D, state=jst, rebalance=False)
    assert dataclasses.asdict(sharded.ParallelConfig.compact(
        cfg, D, st, prior=prior)) == dataclasses.asdict(
            js.ParallelConfig.compact(jcfg, D, jst, prior=jprior))
    for rows in (1, 2):
        assert sharded._ghost_band_keys(cfg, rows) \
            == js._ghost_band_keys(jcfg, rows)
    assert sharded._min_slab_keys(cfg) == js._min_slab_keys(jcfg)
    assert sharded._move_scales(cfg) == js._move_scales(jcfg)
    np.testing.assert_array_equal(
        sharded._np_zxkey(cfg, st.x.numpy()),
        js._np_zxkey(jcfg, np.asarray(jst.x)))


def _refuses(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("case", ["ok", "too_many_slabs", "capacity_128",
                                  "ghost_rows_3", "h_band_needs_2h"])
def test_validate_geometry_refuses_what_jax_refuses(case):
    jcfg, cfg, _, _ = _jax_pair(512)
    pc = dict(n_devices=2, capacity=512, mig_capacity=256,
              ghost_capacity=256)
    pc.update({"ok": {}, "too_many_slabs": dict(n_devices=64),
               "capacity_128": dict(capacity=500),
               "ghost_rows_3": dict(ghost_rows=3),
               "h_band_needs_2h": dict(ghost_rows=1)}[case])
    mine = _refuses(lambda: sharded._validate_geometry(
        cfg, sharded.ParallelConfig(**pc)))
    theirs = _refuses(lambda: js._validate_geometry(
        jcfg, js.ParallelConfig(**pc)))
    assert mine == theirs == (case != "ok")


def test_pack_rows_and_inverse_permutation_equal_jax():
    rng = np.random.default_rng(5)
    pack = jax.jit(js._pack_rows, static_argnums=1)
    for n, density, cap in ((300, 0.3, 128), (300, 0.7, 128), (64, 0.5, 256),
                            (512, 0.0, 128)):
        mask = rng.random(n) < density
        idx, ok, over = sharded._pack_rows(torch.from_numpy(mask), cap)
        jidx, jok, jover = pack(jnp.asarray(mask), cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        assert int(over) == int(jover) == max(0, int(mask.sum()) - cap)
    order = rng.permutation(97)
    np.testing.assert_array_equal(
        sharded._inverse_permutation(torch.from_numpy(order)).numpy(),
        np.asarray(js._inverse_permutation(jnp.asarray(order, jnp.int32))))


# ---------------------------------------------------------------------------
# the move rule against JAX's _update_bounds under shard_map
# ---------------------------------------------------------------------------

MOVE_D = 4
MOVE_CAP = 2048


def _move_inputs(cfg, st, brow):
    """Each rank's (active, key) of a layout by the bounds of brow."""
    x = st.x.numpy()
    cap = MOVE_CAP
    dest = np.searchsorted(brow[2:-1], sharded._np_zxkey(cfg, x),
                           side="right")
    active = np.zeros((MOVE_D, cap), bool)
    key = np.zeros((MOVE_D, cap), np.int32)
    for d in range(MOVE_D):
        sel = np.nonzero(dest == d)[0]
        active[d, :len(sel)] = True
        key[d, :len(sel)] = sharded._np_zxkey(cfg, x[sel])
    return active, key


@pytest.fixture(scope="module")
def move_case():
    """A 4-rank layout off balance (the even key split of a dam break,
    whose particles crowd the low z-rows), and JAX's moves at both
    parities."""
    jcfg, cfg, jst, st = _jax_pair(MOVE_CAP, "dam_break", seed=2)
    b = sharded.initial_bounds(cfg, MOVE_D)
    # the port's rule has no recipient limit; JAX's at the capacity cannot
    # bind (a move keeps the recipient under the donor's load)
    cap_lim = MOVE_CAP
    out = {}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:MOVE_D]), ("z",))
    for ctr in (0, 1):
        brow = np.concatenate([[ctr], b]).astype(np.int32)
        active, key = _move_inputs(cfg, st, brow)
        jp = js.ParallelConfig(n_devices=MOVE_D, capacity=MOVE_CAP,
                               mig_capacity=MOVE_CAP, ghost_capacity=256)

        def body(brow_rows, act, k):
            return js._update_bounds(jcfg, jp, brow_rows[0], act[0], k[0],
                                     cap_lim)[None]

        fn = jax.jit(jax.shard_map(partial(body), mesh=mesh,
                                   in_specs=(P("z"), P("z"), P("z")),
                                   out_specs=P("z"), check_vma=False))
        got = np.asarray(fn(jnp.asarray(np.tile(brow, (MOVE_D, 1))),
                            jnp.asarray(active), jnp.asarray(key)))
        assert (got == got[0]).all()
        out[ctr] = (brow, active, key, got[0])
    return cfg, out


def _port_move(cfg, brow, active, key, mig_capacity):
    pcfg = sharded.ParallelConfig(n_devices=MOVE_D, capacity=MOVE_CAP,
                                  mig_capacity=mig_capacity,
                                  ghost_capacity=256)
    tb = torch.from_numpy(brow)
    g = torch.stack([sharded._strip_pops(cfg, tb, r,
                                         torch.from_numpy(active[r]),
                                         torch.from_numpy(key[r]))
                     for r in range(MOVE_D)])
    return sharded._move_bounds(cfg, pcfg, tb, g).numpy(), g.numpy()


@pytest.mark.parametrize("ctr", [0, 1])
def test_move_rule_equals_jax(move_case, ctr):
    cfg, out = move_case
    brow, active, key, want = out[ctr]
    got, _ = _port_move(cfg, brow, active, key, mig_capacity=MOVE_CAP)
    np.testing.assert_array_equal(got, want)
    assert (got[1:] != brow[1:]).any(), "the case must move a boundary"


@pytest.mark.parametrize("ctr", [0, 1])
def test_move_rule_donates_no_strip_beyond_mig_capacity(move_case, ctr):
    """The port's deliberate difference: where JAX donates a strip of more
    than mig_capacity particles (its migration would overflow and drop
    them), the port tries the next finer scale instead."""
    cfg, out = move_case
    brow, active, key, want = out[ctr]
    _, g = _port_move(cfg, brow, active, key, mig_capacity=MOVE_CAP)
    jax_shift = want[2:-1] - brow[2:-1]
    moved = np.nonzero(jax_shift)[0]
    scales = sharded._move_scales(cfg)
    # the strip each JAX move donated, and a capacity just below the largest
    strip = [int(g[i, 2 + 2 * scales.index(-s)]) if s < 0
             else int(g[i + 1, 1 + 2 * scales.index(s)])
             for i, s in zip(moved, jax_shift[moved])]
    mig_cap = max(strip) - 1
    got, _ = _port_move(cfg, brow, active, key, mig_capacity=mig_cap)
    shift = got[2:-1] - brow[2:-1]
    for i, s, pop in zip(moved, jax_shift[moved], strip):
        if pop <= mig_cap:
            assert shift[i] == s
        else:
            assert 0 <= shift[i] / s < 1, (shift[i], s)
            if shift[i]:
                k = scales.index(abs(int(shift[i])))
                donated = (g[i, 2 + 2 * k] if shift[i] < 0
                           else g[i + 1, 1 + 2 * k])
                assert donated <= mig_cap
    assert (shift != jax_shift).any()


# ---------------------------------------------------------------------------
# restrict_plan
# ---------------------------------------------------------------------------

def test_restrict_plan_masks_the_chunks_jax_masks():
    jcfg, cfg, jst, st = _jax_pair(2048, "dam_break", seed=1)
    cid = hashgrid.cell_ids(cfg, st.x)
    sorted_cid, _ = tstep.sort_cells(cfg, cid)
    assert sorted_cid.shape[0] == jpp.pad_to_chunks(jcfg, cfg.n)
    b = sharded.initial_bounds(cfg, 2, state=st)
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    jplan = jpp.build_plan(jcfg, jnp.asarray(sorted_cid.numpy()))
    segw = jcfg.geom.segw
    total = np.asarray(jplan.seg_src[:, 0, segw - 1])
    cand = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1).numpy()
    np.testing.assert_array_equal(cand > 0, total > 0)
    for lo, hi in ((b[0], b[1]), (b[1], b[2])):
        keeps = sharded.chunk_keep(cfg, sorted_cid, lo, hi)
        w = cfg.nb_grid_width
        cid_c = jnp.asarray(sorted_cid.numpy()).reshape(-1, jcfg.geom.own)
        kc = (cid_c // (w * w)) * w + cid_c % w
        jkeeps = (((kc >= lo - w - 1) & (kc < hi + w + 1)).any(axis=1),
                  ((kc >= lo) & (kc < hi)).any(axis=1))
        for keep, jkeep in zip(keeps, jkeeps):
            np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
            r = cuda_pbf.restrict_plan(cfg, plan, keep)
            jr = np.asarray(jpp.restrict_plan(jcfg, jplan, jkeep)
                            .seg_src[:, 0, segw - 1])
            rc = (r.ranges[..., 1] - r.ranges[..., 0]).sum(dim=1).numpy()
            np.testing.assert_array_equal(rc > 0, jr > 0)
            k = keep.numpy()
            assert torch.equal(r.ranges[k], plan.ranges[k])
            assert not rc[~k].any() and 0 < k.sum() < k.size
            seg_len, prefix, total = cuda_pbf.work_table(
                cfg, torch.from_numpy(rc))
            assert torch.equal(r.seg_prefix, prefix)
            assert torch.equal(r.seg_len, seg_len)
            assert torch.equal(r.n_candidates, total)


FORMS = [dict(), dict(mxu_rd2=True, mxu_sum=True), dict(mxu_proj=True),
         dict(mxu_sum=True)]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("switches", FORMS,
                         ids=["fp32", "rd2_sum", "proj", "sum"])
def test_masked_chunks_still_write_their_rows(switches, split):
    """JAX's rule for a masked chunk: lambda from zero sums, the position
    unchanged, rho 0; kept chunks as on the unrestricted plan. Every
    chunk masked is the case of a batch without candidates."""
    cfg = default_config(n=1024, geom=KernelGeometry(**switches))
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    st = tstep.make_rollout(cfg, "window", 8, device="cpu")(st)
    sorted_cid, order = tstep.sort_cells(cfg, hashgrid.cell_ids(cfg, st.x))
    n = cfg.n
    p4 = torch.zeros((sorted_cid.shape[0], 4))
    p4[:n, :3] = st.x[order]
    p4[:n, 3] = torch.linspace(-1e-3, 1e-3, n)
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    chunks = plan.ranges.shape[0]
    lam0 = np.float32(1.0) / np.float32(cfg.relaxation_eps)
    for keep in (torch.arange(chunks) % 3 != 1, torch.zeros(chunks, dtype=torch.bool)):
        r = cuda_pbf.restrict_plan(cfg, plan, keep)
        rows = keep.repeat_interleave(cfg.geom.own)[:n]
        full = cuda_pbf.density_pass_ref(cfg, p4, plan, n, split=split)
        got = cuda_pbf.density_pass_ref(cfg, p4, r, n, split=split)
        # kept rows: the sums of the unrestricted plan (the plain version
        # may batch the chunks otherwise, so not bit for bit)
        torch.testing.assert_close(got[:n][rows], full[:n][rows],
                                   rtol=1e-6, atol=1e-9)
        assert (got[:n, 3][~rows] == torch.tensor(lam0)).all()
        proj_full = cuda_pbf.project_pass_ref(cfg, p4, plan, n, split=split)
        proj = cuda_pbf.project_pass_ref(cfg, p4, r, n, split=split)
        torch.testing.assert_close(proj[:n][rows], proj_full[:n][rows],
                                   rtol=1e-6, atol=1e-9)
        assert torch.equal(proj[:n][~rows], p4[:n][~rows])
        rho = cuda_pbf.density_rho_ref(cfg, p4, r, n, split=split)
        assert (rho[:n, 3][~rows] == 0).all()


# ---------------------------------------------------------------------------
# the sharded step against the port's single-device step
# ---------------------------------------------------------------------------

def _cfg():
    # capacity 16 holds the densest cell of the 1024 dam break (cell)
    return default_config(n=1024, cell_capacity=16, block=16,
                          max_occupied_cells=1024)


def _single(cfg, st, backend, steps=STEPS):
    stepper = tstep.make_step(cfg, backend, device="cpu")
    for _ in range(steps):
        st, stats = stepper.step(st, with_stats=True)
        assert stats.tolist() == [0, 0, 0]
    inv = torch.argsort(st.ids.long())
    return st.x[inv], st.v[inv], tstep.diagnostics_fn(cfg, st)


def test_one_rank_fast_path_is_the_stepper_bit_for_bit():
    cfg = _cfg()
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    assert pcfg.capacity == cfg.n
    sst = sharded.distribute(cfg, pcfg, st, device="cpu")
    step = sharded.make_sharded_step(cfg, pcfg, device="cpu")
    stepper = tstep.make_step(cfg, "window", device="cpu")
    ref = st
    for _ in range(STEPS):
        sst, stats, diag = step(sst)
        ref = stepper(ref)
        assert torch.equal(sst.x, ref.x) and torch.equal(sst.v, ref.v)
        assert torch.equal(sst.ids, ref.ids)
    assert stats.tolist() == [[cfg.n, 0, 0, 0, 0]]
    assert diag.shape == (1, 3) and diag[0, 2] == 0
    got = sharded.collect(sst)
    assert torch.equal(got.ids, torch.arange(cfg.n, dtype=torch.int32))


@pytest.fixture(scope="module")
def references():
    cfg = _cfg()
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    return cfg, st, {b: _single(cfg, st, b) for b in ("window", "cell")}


@pytest.mark.parametrize("backend", ["window", "cell"])
@pytest.mark.parametrize("D", [2, 4])
def test_gloo_ranks_match_the_single_device_step(references, D, backend):
    cfg, st, ref = references
    (got, stats, diag, _, dens, _), = launch.rollout_ranks(
        cfg, st, D, [STEPS], backend=backend, devices=["cpu"] * D,
        timeout_s=RANK_TIMEOUT_S)[0]
    assert stats.shape == (D, 5) and diag.shape == (D, 3)
    assert stats[:, 1:].sum() == 0, stats.tolist()
    assert stats[:, 0].sum() == cfg.n and (stats[:, 0] > 0).all()
    assert diag[:, 2].sum() == 0
    assert torch.equal(got.ids, torch.arange(cfg.n, dtype=torch.int32))
    want_x, want_v, want_d = ref[backend]
    np.testing.assert_allclose(got.x.numpy(), want_x.numpy(), rtol=X_RTOL,
                               atol=X_ATOL)
    np.testing.assert_allclose(got.v.numpy(), want_v.numpy(), rtol=V_RTOL,
                               atol=V_ATOL)
    # the sharded density diagnostics, weighted by each rank's particles
    # as the runner weighs them, against the single device's
    w = stats[:, 0].double()
    mean = float((dens[:, 0].double() * w).sum() / w.sum())
    assert mean == pytest.approx(float(want_d.mean_density), rel=DENS_RTOL)
    assert float(dens[:, 1].max()) == pytest.approx(
        float(want_d.max_density_err), abs=DENS_ERR_ATOL)
    assert dens[:, 4].sum() == 0


def test_forced_migration_overflow_is_counted(references):
    """Rank 0's particles all head for rank 1 at once, through a migration
    buffer of 128 slots: every one past the 128th is counted and dropped."""
    cfg, st, _ = references
    pcfg = sharded.ParallelConfig.create(cfg, 2, state=st)
    pcfg = dataclasses.replace(pcfg, mig_capacity=128)
    b = sharded.initial_bounds(cfg, 2, state=st)
    on0 = int((sharded._np_zxkey(cfg, st.x.numpy()) < b[1]).sum())
    v = st.v.clone()
    v[:, 2] = 200.0   # every particle moves a whole box up in one step
    (got, stats, _, _, _, _), = launch.rollout_ranks(
        cfg, st._replace(v=v), 2, [1], pcfg=pcfg, devices=["cpu"] * 2,
        timeout_s=RANK_TIMEOUT_S)[0]
    assert on0 > 128
    assert int(stats[:, 1].sum()) == on0 - 128
    assert int(stats[:, 0].sum()) == cfg.n - (on0 - 128)
    assert got.ids.shape[0] == cfg.n - (on0 - 128)
    assert torch.isfinite(got.x).all()


@pytest.mark.parametrize("away", [2, 3])
def test_a_particle_ranks_away_arrives_within_the_step(references, away):
    """The soak's fault (the blowup at D = 8 on the CPU, the 1M blowup at
    D = 4 on the cards): a particle whose predicted key lies `away` slabs
    on goes all the way in the step, through the ranks between, where JAX
    takes it one rank and counts an overflow. Here one particle of rank 0
    is sent to the middle of rank `away`'s slab, above the fluid: no
    counter fires, and the step is the single device's."""
    cfg, st, _ = references
    D, w = 4, cfg.nb_grid_width
    b = sharded.initial_bounds(cfg, D, state=st)
    key = sharded._np_zxkey(cfg, st.x.numpy())
    i = int(np.argmin(key))
    target_key = (int(b[away]) + int(b[away + 1])) // 2
    # a boundary moves at most w keys a step
    assert b[away] + w < target_key < b[away + 1] - w
    target = torch.tensor([(target_key % w + 0.5) * cfg.nb_cell,
                           cfg.wall - cfg.nb_cell,
                           (target_key // w + 0.5) * cfg.nb_cell])
    v = st.v.clone()
    g = torch.tensor([0.0, cfg.gravity, 0.0])
    v[i] = (target - st.x[i]) / cfg.dt / cfg.velocity_damp - cfg.dt * g
    moved = st._replace(v=v)
    (got, stats, diag, _, _, _), = launch.rollout_ranks(
        cfg, moved, D, [1], devices=["cpu"] * D,
        timeout_s=RANK_TIMEOUT_S)[0]
    assert stats[:, 1:].sum() == 0, stats.tolist()
    assert stats[:, 0].sum() == cfg.n and diag[:, 2].sum() == 0
    want_x, _, _ = _single(cfg, moved, "window", steps=1)
    assert sharded._np_zxkey(cfg, want_x[i:i + 1].numpy())[0] == target_key
    np.testing.assert_allclose(got.x.numpy(), want_x.numpy(), rtol=X_RTOL,
                               atol=X_ATOL)


@pytest.mark.parametrize("case", ["rank_raises", "time_limit"])
def test_rank_failure_fails_the_run(references, case):
    """A rank that raises, or ranks that outlive their time limit, fail the
    run, and no rank is left behind: the error carries the rank's
    traceback, or every rank's last note."""
    cfg, st, _ = references
    if case == "rank_raises":
        bad = sharded.ParallelConfig(n_devices=2, capacity=128,
                                     mig_capacity=128, ghost_capacity=128)
        run = dict(chunks=[1], pcfg=bad, timeout_s=RANK_TIMEOUT_S)
    else:
        run = dict(chunks=[100_000], timeout_s=1.0)
    with pytest.raises(launch.RankFailure,
                       match=r"failed: Traceback(?s:.*)ValueError: shard"
                       if case == "rank_raises" else
                       r"limit of 1.0 s; last notes: rank 0: .*; rank 1: "):
        launch.rollout_ranks(cfg, st, 2, devices=["cpu"] * 2, **run)
    assert not multiprocessing.active_children()


def test_ranks_default_to_one_card_each(references):
    """Without `devices`, the ranks ask for a card each: with fewer cards
    than ranks the call raises before it starts any process."""
    cfg, st, _ = references
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks need {n} cards"):
        launch.rollout_ranks(cfg, st, n, [1], timeout_s=RANK_TIMEOUT_S)
    assert not multiprocessing.active_children()
