"""The port's candidate-window plan: coverage against brute force, and
the card's plan kernels' algorithm against the plain plan.

The port of `test_window_plan_covers_all_pairs` and
`test_window_plan_mixed_chunk_covers_all_pairs` (tests/test_pallas.py),
for exact element ranges instead of the TPU's 128-lane segments. The
kernels of csrc/pbf_plan.cu cannot run here: `_mirror_plan` repeats their
per-chunk algorithm in numpy (a binary search a window bound, the running
max over the nine windows, the work table's truncating division), and the
tests hold it to build_plan_ref field for field; chip_smoke.py holds the
kernels to build_plan_ref on the card.

The work table's two counters (`pair_items`, `chunk_items_max`): the plain
table adds its items and its most items of one chunk, the step adds them
once a step, and the sharded callers add nothing. The test marked `card`
holds the kernel's counters to the plain ones on a card, with

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" \
        -m card tests/test_torch_plan.py

and skips without one; JAX is imported only where the JAX test needs it,
since the card's machine does not have it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.config import default_config
from pdb_sph_tpu_torch.geometry import KernelGeometry
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

torch.set_num_threads(1)


def _sorted(cfg, x: np.ndarray, extra_pad: int = 0):
    """Cell-sort positions as the step does; optionally pad further."""
    n = x.shape[0]
    n_pad = cuda_pbf.pad_to_chunks(cfg, n) + extra_pad
    cid = hashgrid.cell_ids(cfg, torch.tensor(x))
    cid_pad = torch.cat([cid, cid.new_full((n_pad - n,), cfg.num_nb_cells)])
    sc, order = hashgrid.sort_by_cell(cfg, cid_pad)
    return sc, x[order[:n].numpy()]


def _coverage(ranges_row: np.ndarray, n: int) -> np.ndarray:
    """How often each sorted particle appears in one chunk's windows."""
    covered = np.zeros(n, dtype=int)
    for start, end in ranges_row:
        assert 0 <= start <= end <= n, (start, end)
        covered[start:end] += 1
    return covered


def _check_chunks(cfg, plan, ps, chunks):
    own, n = cfg.geom.own, ps.shape[0]
    ranges = plan.ranges.numpy()
    for c in chunks:
        starts = ranges[c, :, 0]
        assert (np.diff(starts) >= 0).all(), f"chunk {c}: not ascending"
        covered = _coverage(ranges[c], n)
        assert covered.max() <= 1, f"chunk {c}: candidate counted twice"
        mine = ps[c * own:min((c + 1) * own, n)]
        d = mine[:, None, :] - ps[None, :, :]
        within = (d * d).sum(-1) < cfg.h2
        for i in range(mine.shape[0]):
            js = np.nonzero(within[i])[0]
            assert (covered[js] == 1).all(), (
                f"chunk {c} misses {np.sum(covered[js] != 1)}/{len(js)} "
                f"neighbours of own row {i}")


@pytest.mark.parametrize("own", [64, 128])
def test_window_plan_covers_all_pairs(own):
    """Every pair within h falls in exactly one window of its chunk."""
    import pdb_sph_tpu as jpbf

    jcfg = jpbf.default_config(n=384)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    cfg = dataclasses.replace(cfg, geom=dataclasses.replace(cfg.geom,
                                                            own=own))
    x = np.asarray(jpbf.spawn(jcfg, "blowup", seed=3).x)
    sc, ps = _sorted(cfg, x)
    plan = cuda_pbf.build_plan(cfg, sc)
    assert plan.ranges.dtype == torch.int32
    assert tuple(plan.ranges.shape) == (sc.shape[0] // own, 9, 2)
    assert int(plan.n_overflow) == 0
    _check_chunks(cfg, plan, ps, range(plan.ranges.shape[0]))


def test_window_plan_mixed_chunk_covers_all_pairs():
    """With n % own != 0 the last chunk mixes real and padding entries; its
    windows must come from its real span only (round-1 bug of the JAX plan:
    a padding c_last stretched them to the end of the grid)."""
    n = 16040
    cfg = default_config(n=n)
    assert n % cfg.geom.own != 0
    rng = np.random.default_rng(7)
    x = np.stack([rng.random(n) * 2.0, rng.random(n) * 2.0,
                  rng.random(n) * 0.09], axis=1).astype(np.float32)
    sc, ps = _sorted(cfg, x)
    plan = cuda_pbf.build_plan(cfg, sc)
    last = (n - 1) // cfg.geom.own
    _check_chunks(cfg, plan, ps, (last, last - 1))
    # the mixed chunk's windows stay near its own span
    assert int((plan.ranges[last, :, 1] - plan.ranges[last, :, 0]).sum()) \
        < n // 4


def test_all_pad_chunks_get_empty_windows():
    cfg = default_config(n=300)
    x = np.random.default_rng(1).random((300, 3)).astype(np.float32)
    sc, _ = _sorted(cfg, x, extra_pad=2 * cfg.geom.own)
    plan = cuda_pbf.build_plan(cfg, sc)
    nc_real = -(-300 // cfg.geom.own)
    assert plan.ranges.shape[0] == nc_real + 2
    assert not plan.ranges[nc_real:].any()
    assert (plan.ranges[:nc_real, :, 1] <= 300).all()


def test_cummax_carry_equals_sequential_dedup():
    """The closed-form carry equals JAX's sequential `dedup_q` scan without
    quantisation, on arbitrary (also empty and inverted) ranges."""
    rng = np.random.default_rng(5)
    start = np.sort(rng.integers(0, 500, (64, 9)), axis=1)
    end = start + rng.integers(-20, 120, (64, 9))
    carry = np.zeros(64, dtype=np.int64)
    want = np.zeros((64, 9, 2), dtype=np.int64)
    for w in range(9):
        s2 = np.maximum(start[:, w], carry)
        e2 = np.where(end[:, w] > s2, end[:, w], s2)
        want[:, w] = np.stack([s2, e2], axis=1)
        carry = e2
    s, e = cuda_pbf.disjoint_windows(torch.from_numpy(start),
                                     torch.from_numpy(end))
    np.testing.assert_array_equal(torch.stack([s, e], dim=-1).numpy(), want)


# ---------------------------------------------------------------------------
# the plan kernels' algorithm (csrc/pbf_plan.cu) against the plain plan
# ---------------------------------------------------------------------------

def _lower_bound(ids: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """The kernel's binary search, one per key: the first index of the
    sorted `ids` whose value is not below the key."""
    lo = np.zeros(keys.shape, dtype=np.int64)
    n = np.full(keys.shape, ids.shape[0], dtype=np.int64)
    while (n > 0).any():
        half = n >> 1
        probe = ids[np.minimum(lo + half, ids.shape[0] - 1)]
        less = (n > 0) & (probe < keys)
        lo = np.where(less, lo + half + 1, lo)
        n = np.where(less, n - half - 1, half)
    return lo


def _trunc_div(a: np.ndarray, b: int) -> np.ndarray:
    """C's integer division, which truncates toward zero (b > 0)."""
    return np.sign(a) * (np.abs(a) // b)


def _mirror_table(cand: np.ndarray, seg: int):
    """work_table_kernel: (seg_len, seg_prefix, total)."""
    chunks = cand.shape[0]
    spare = (cuda_pbf.ITEMS_PER_CHUNK - 1) * chunks
    total = int(cand.sum())
    seg_len = max(seg, int(_trunc_div(np.int64(total + spare - 1), spare)))
    items = np.maximum(_trunc_div(cand - 1, seg_len) + 1, 1)
    return seg_len, np.concatenate([[0], np.cumsum(items)]), total


def _mirror_plan(cfg, sorted_cid: torch.Tensor):
    """plan_windows_kernel then work_table_kernel, chunk by chunk: (ranges,
    seg_len, seg_prefix, total)."""
    ids = sorted_cid.numpy().astype(np.int64)
    own, ncells, w = cfg.geom.own, cfg.num_nb_cells, cfg.nb_grid_width
    chunks = ids.shape[0] // own
    chunk = ids[:chunks * own].reshape(chunks, own)
    c_first = chunk[:, 0]
    c_last = np.where(chunk < ncells, chunk, -1).max(axis=1)
    win = np.arange(9)
    off = (win // 3 - 1) * w * w + (win % 3 - 1) * w
    lo = np.clip(c_first[:, None] + off - 1, 0, ncells)
    hi = np.clip(c_last[:, None] + off + 1, -1, ncells - 1)
    start, end = _lower_bound(ids, lo), _lower_bound(ids, hi + 1)
    ranges = np.zeros((chunks, 9, 2), dtype=np.int64)
    carry = np.zeros(chunks, dtype=np.int64)  # the exclusive running max
    for k in range(9):
        s = np.maximum(start[:, k], carry)
        ranges[:, k] = np.stack([s, np.maximum(end[:, k], s)], axis=1)
        carry = np.maximum(carry, np.maximum(start[:, k], end[:, k]))
    ranges[c_first >= ncells] = 0
    cand = (ranges[..., 1] - ranges[..., 0]).sum(axis=1)
    return (ranges, *_mirror_table(cand, cfg.geom.seg))


def _cfg(n: int, own: int):
    return default_config(n=n, geom=KernelGeometry(own=own))


def _spawn_ids(cfg, extra_chunks: int):
    """Sorted ids of a random box (n % own != 0: a mixed last chunk) with
    `extra_chunks` all-pad chunks after it."""
    x = np.random.default_rng(cfg.geom.own).random((cfg.n, 3))
    return _sorted(cfg, (x * cfg.wall).astype(np.float32),
                   extra_pad=extra_chunks * cfg.geom.own)[0]


def _sparse_ids(cfg, extra_chunks: int):
    """Sorted ids on a few scattered cells, cell 0 and cell ncells - 1
    among them: windows that find nothing between occupied cells, a mixed
    last chunk and `extra_chunks` all-pad chunks."""
    ncells, own = cfg.num_nb_cells, cfg.geom.own
    rng = np.random.default_rng(own + 1)
    cells = np.concatenate([[0, ncells - 1],
                            rng.choice(ncells, 40, replace=False)])
    ids = np.sort(rng.choice(cells, cfg.n))
    ids[:3], ids[-3:] = 0, ncells - 1
    n_pad = cuda_pbf.pad_to_chunks(cfg, cfg.n) + extra_chunks * own
    ids = np.concatenate([ids, np.full(n_pad - cfg.n, ncells)])
    return torch.from_numpy(ids.astype(np.int32))


CASES = {"spawn": _spawn_ids, "sparse": _sparse_ids}


def _assert_plan_is(plan, ranges, seg_len, seg_prefix, total):
    assert plan.ranges.dtype == plan.seg_len.dtype == torch.int32
    assert plan.seg_prefix.dtype == plan.n_overflow.dtype == torch.int32
    assert plan.n_candidates.dtype == torch.int64
    np.testing.assert_array_equal(plan.ranges.numpy(), ranges)
    assert int(plan.seg_len) == seg_len and int(plan.n_overflow) == 0
    np.testing.assert_array_equal(plan.seg_prefix.numpy(), seg_prefix)
    assert int(plan.n_candidates) == total


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("own", [32, 64, 128, 256])
def test_the_kernels_algorithm_is_the_plain_plan(own, case):
    """The kernels' per-chunk algorithm (_mirror_plan) gives
    build_plan_ref's every field exactly: mixed and all-pad chunks,
    ids at cell 0 and at the last cell, windows with nothing in them."""
    cfg = _cfg(1000 + own // 2, own)
    sorted_cid = CASES[case](cfg, extra_chunks=2)
    ranges, seg_len, seg_prefix, total = _mirror_plan(cfg, sorted_cid)
    chunks = ranges.shape[0]
    real = cuda_pbf.pad_to_chunks(cfg, cfg.n) // own
    assert cfg.n % own and chunks == real + 2
    assert not ranges[real:].any()  # the all-pad chunks' cand is 0
    assert (ranges[..., 1] == ranges[..., 0]).any(axis=1)[:real].any()
    _assert_plan_is(cuda_pbf.build_plan_ref(cfg, sorted_cid), ranges,
                    seg_len, seg_prefix, total)


@pytest.mark.parametrize("stretch", [False, True])
def test_the_kernels_work_table_is_the_plain_one(stretch):
    """work_table_kernel's arithmetic (_mirror_table, C's truncating
    division) gives work_table_ref's table: chunks without candidates take
    one item, and at the 2M row's 31,250 chunks candidates beyond the
    scratch's items stretch the segments (test_torch_scale's case)."""
    chunks, seg = 31_250, KernelGeometry().seg
    rng = np.random.default_rng(3)
    cand = rng.integers(0, (40 if stretch else 4) * seg, size=chunks)
    cand[rng.choice(chunks, 500, replace=False)] = 0
    cand[7] = 200_000
    seg_len, seg_prefix, total = _mirror_table(cand, seg)
    assert (seg_len > seg) == stretch
    got = cuda_pbf.work_table_ref(_cfg(64, 64), torch.from_numpy(cand))
    assert int(got[0]) == seg_len and int(got[2]) == total
    np.testing.assert_array_equal(got[1].numpy(), seg_prefix)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cpu_plan_launches_nothing_and_is_the_plain_plan(case):
    """On a CPU tensor build_plan, work_table and restrict_plan run the
    plain versions: no kernel launch is counted, and every field is the
    _ref functions' bit for bit."""
    cfg = _cfg(1000, 64)
    sorted_cid = CASES[case](cfg, extra_chunks=1)
    before = dict(cuda_pbf.LAUNCHES)
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    want = cuda_pbf.build_plan_ref(cfg, sorted_cid)
    cand = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    table = cuda_pbf.work_table(cfg, cand)
    keep = torch.arange(plan.ranges.shape[0]) % 2 == 0
    restricted = cuda_pbf.restrict_plan(cfg, plan, keep)
    assert cuda_pbf.LAUNCHES == before
    for got, ref in zip(plan, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    for got, ref in zip(table, cuda_pbf.work_table_ref(cfg, cand)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert torch.equal(table[0], plan.seg_len)
    assert torch.equal(table[1], plan.seg_prefix)
    assert torch.equal(table[2], plan.n_candidates)
    r_cand = (restricted.ranges[..., 1]
              - restricted.ranges[..., 0]).sum(dim=1)
    assert not r_cand[~keep].any()
    assert torch.equal(restricted.seg_prefix,
                       cuda_pbf.work_table_ref(cfg, r_cand)[1])


def test_a_plan_on_a_device_without_kernels_raises():
    """No silent fallback: a tensor neither on the CPU nor on a card gets
    no plan and no work table."""
    cfg = _cfg(256, 64)
    ids = torch.zeros((256,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no plan kernel"):
        cuda_pbf.build_plan(cfg, ids)
    with pytest.raises(ValueError, match="no plan kernel"):
        cuda_pbf.work_table(cfg, torch.zeros((4,), dtype=torch.int64,
                                             device="meta"))


# ---------------------------------------------------------------------------
# the work table's counters
# ---------------------------------------------------------------------------

ITEM_COUNTERS = ("pair_items", "chunk_items_max")


def _item_counters(device="cpu") -> dict:
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in ITEM_COUNTERS}


def _synthetic_cand(stretch: bool) -> np.ndarray:
    """test_the_kernels_work_table_is_the_plain_one's chunks: 31,250 of
    them, 500 empty, one of 200,000 candidates, stretched or not."""
    seg = KernelGeometry().seg
    rng = np.random.default_rng(3)
    cand = rng.integers(0, (40 if stretch else 4) * seg, size=31_250)
    cand[rng.choice(cand.size, 500, replace=False)] = 0
    cand[7] = 200_000
    return cand


@pytest.mark.parametrize("stretch", [False, True])
def test_the_plain_table_adds_its_items_to_the_counters(stretch):
    """work_table_ref adds seg_prefix[-1] into pair_items and the most
    items of one chunk (_mirror_table's, at the stretched length where the
    segments stretch) into chunk_items_max, at every call; the table is
    the one it gives without counters."""
    cand = _synthetic_cand(stretch)
    seg_len, seg_prefix, _ = _mirror_table(cand, KernelGeometry().seg)
    most = int(np.diff(seg_prefix).max())
    assert most == max(1, -(-200_000 // seg_len))
    cfg, counters = _cfg(64, 64), _item_counters()
    plain = cuda_pbf.work_table_ref(cfg, torch.from_numpy(cand))
    for calls in (1, 2):
        got = cuda_pbf.work_table_ref(cfg, torch.from_numpy(cand), counters)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        assert int(counters["pair_items"]) == calls * int(seg_prefix[-1])
        assert int(counters["chunk_items_max"]) == calls * most
    assert counters["pair_items"].dtype == torch.int64


def test_the_plain_table_of_empty_chunks_counts_one_item_each():
    """Chunks without candidates take one item each: the most is 1."""
    counters = _item_counters()
    cuda_pbf.work_table_ref(_cfg(64, 64), torch.zeros((5,), dtype=torch.int64),
                            counters)
    assert [int(counters[k]) for k in ITEM_COUNTERS] == [5, 1]


@pytest.mark.parametrize("bad", [torch.zeros((), dtype=torch.int32),
                                 torch.zeros((1,), dtype=torch.int64),
                                 torch.zeros((), dtype=torch.int64,
                                             device="meta")],
                         ids=["int32", "not-0-dim", "another-device"])
def test_a_counter_the_kernel_could_not_write_raises(bad):
    """A work-item counter that is not a 0-dim int64 on the table's
    device is refused before any pointer is taken."""
    counters = _item_counters() | {"chunk_items_max": bad}
    with pytest.raises(ValueError, match="work-item counter"):
        cuda_pbf.work_table(_cfg(64, 64), torch.ones((3,), dtype=torch.int64),
                            counters)


@pytest.fixture
def card():
    """The card, or skip: decided when a test asks, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("stretch", [False, True])
def test_the_kernels_counters_are_the_plain_ones(card, stretch):
    """On a card work_table_kernel writes the plain table's counters, twice
    added; without counters it adds nothing; and a plan built with them
    adds its table's."""
    cfg = _cfg(64, 64)
    cand = torch.from_numpy(_synthetic_cand(stretch))
    want = _item_counters()
    cuda_pbf.work_table_ref(cfg, cand, want)
    got = _item_counters(card)
    for _ in range(2):
        cuda_pbf.work_table(cfg, cand.to(card), got)
    cuda_pbf.work_table(cfg, cand.to(card))
    torch.cuda.synchronize()
    assert [int(got[k]) for k in ITEM_COUNTERS] \
        == [2 * int(want[k]) for k in ITEM_COUNTERS]
    cfg = _cfg(20_000 + 17, 64)
    sorted_cid = _spawn_ids(cfg, extra_chunks=2)
    want, got = _item_counters(), _item_counters(card)
    cuda_pbf.build_plan_ref(cfg, sorted_cid, want)
    cuda_pbf.build_plan(cfg, sorted_cid.to(card), got)
    torch.cuda.synchronize()
    assert [int(got[k]) for k in ITEM_COUNTERS] \
        == [int(want[k]) for k in ITEM_COUNTERS]
    assert int(want["pair_items"]) > cfg.n // 64


def _tables(monkeypatch) -> list:
    """The counters argument of every work_table_ref call from now on."""
    seen, real = [], cuda_pbf.work_table_ref

    def spy(cfg, cand, counters=None):
        seen.append(counters)
        return real(cfg, cand, counters)

    monkeypatch.setattr(cuda_pbf, "work_table_ref", spy)
    return seen


def test_the_step_adds_the_items_once_a_step(monkeypatch):
    """Over a CPU Rollout's steps the counters are the sums of each step's
    plan: its items (seg_prefix[-1]) and its most items of one chunk,
    recomputed here from the same states, each plan's table made once."""
    from pdb_sph_tpu_torch import spawn
    from pdb_sph_tpu_torch.core import step as tstep
    from pdb_sph_tpu_torch.ops.integrate import predict

    cfg = default_config(n=2000)
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    seen = _tables(monkeypatch)
    rollout = tstep.make_rollout(cfg, "window", 3, device="cpu")
    got = rollout(st)
    assert len(seen) == 3 and all(c is rollout.stepper.counters
                                  for c in seen)
    items = most = 0
    for _ in range(3):
        p, _ = predict(cfg, st.x, st.v)
        sorted_cid, _ = tstep.sort_cells(cfg, hashgrid.cell_ids(cfg, p))
        prefix = cuda_pbf.build_plan_ref(cfg, sorted_cid).seg_prefix
        items += int(prefix[-1])
        most += int((prefix[1:] - prefix[:-1]).max())
        st = tstep.step_fn(cfg, "window", st)
    assert all(torch.equal(a, b) for a, b in zip(got, st))
    counters = rollout.stepper.counters
    assert int(counters["pair_items"]) == items > 3 * cfg.n // cfg.geom.own
    assert int(counters["chunk_items_max"]) == most >= 3


def test_the_sharded_callers_add_nothing(monkeypatch):
    """The one-rank fast path's step and diagnostics, a rank's plans and
    their restricted tables (sharded._window_plans) and restrict_plan
    build every table without counters."""
    from pdb_sph_tpu_torch import spawn
    from pdb_sph_tpu_torch.parallel import sharded

    cfg = default_config(n=1024)
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    sst = sharded.distribute(cfg, pcfg, st, device="cpu")
    seen = _tables(monkeypatch)
    sharded.make_sharded_step(cfg, pcfg, device="cpu")(sst)
    fast = len(seen)
    cid = hashgrid.cell_ids(cfg, st.x)
    sharded._window_plans(cfg, cid, (int(cid.median()), int(cid.max()) + 1))
    assert fast >= 1 and len(seen) == fast + 3
    assert all(c is None for c in seen)
