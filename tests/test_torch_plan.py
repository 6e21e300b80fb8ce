"""The port's candidate-window plan: coverage against brute force.

The port of `test_window_plan_covers_all_pairs` and
`test_window_plan_mixed_chunk_covers_all_pairs` (tests/test_pallas.py),
for exact element ranges instead of the TPU's 128-lane segments.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.config import default_config
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
