"""The census of pairs within h and the neighbour search it shares with the
reference, against a brute-force count."""

import pytest
import torch

from pbfbench import neighbours, work


def brute_pairs(x: torch.Tensor, h: float) -> int:
    d = x[:, None, :] - x[None, :, :]
    rd2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return int((rd2 < h * h).sum())


@pytest.mark.parametrize("n, extent, h", [(1, 1.0, 0.1), (500, 0.4, 0.1),
                                          (1500, 1.0, 0.1), (800, 0.3, 0.07)])
def test_the_census_counts_the_pairs_within_h(n, extent, h):
    gen = torch.Generator().manual_seed(n)
    x = torch.rand((n, 3), generator=gen) * extent
    assert work.pairs_within(x, h) == brute_pairs(x, h)


def test_the_census_counts_coincident_and_lattice_points():
    """Points on a lattice of spacing h have no neighbour within h (< is
    strict) but themselves; coincident points count each other."""
    g = torch.arange(6, dtype=torch.float32) * 0.1
    x = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).view(-1, 3)
    x = torch.cat([x, x[:5]])
    assert work.pairs_within(x, 0.1) == brute_pairs(x, 0.1)


def test_a_block_boundary_loses_no_pair():
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((700, 3), generator=gen) * 0.5
    cell = (x / 0.1).floor().long().clamp(0, 4)
    cell, order = torch.sort(cell[:, 0] + 5 * (cell[:, 1] + 5 * cell[:, 2]))
    grid = neighbours.make_grid(cell, 5)
    for rows in (7, 64, 700):
        total = sum(i.numel() for i, _, _, _ in
                    neighbours.near_pairs(grid, x[order], 0.01, rows))
        assert total == brute_pairs(x, 0.1)


def test_flops_and_bytes_of_a_step():
    assert work.pair_flops(10, 3) == 10 * 3 * 36
    assert work.pair_bytes(5, 3) == 5 * 3 * 44
    peak = {"fp32_flop_per_s": 1e3, "hbm_byte_per_s": 1e3}
    assert work.least_seconds(10, 1, 3, peak) == (1.08, "flops")
    assert work.least_seconds(0, 100, 3, peak) == (13.2, "bytes")
    assert work.peaks("NVIDIA H100 80GB HBM3")["fp32_flop_per_s"] == 67e12
    assert work.peaks("no such card") is None


@pytest.mark.parametrize("spawn", [
    {"shape": "box", "lo": [0.0, 0.0, 0.0], "hi": [0.25, 1.0, 0.5]},
    {"shape": "box", "lo": [0.7, 0.7, 0.7], "hi": [0.995, 0.995, 0.995]}])
def test_the_spawn_is_the_seeds_and_fills_its_shape(spawn):
    from pbfbench import harness

    conf = {"spawn": spawn, "n": 4000, "wall": 2.0}
    dev = torch.device("cpu")
    x, v, ids, step = harness.spawn(conf, 2 ** 33 + 5, dev)
    assert torch.equal(x, harness.spawn(conf, 2 ** 33 + 5, dev)[0])
    assert not torch.equal(x, harness.spawn(conf, 6, dev)[0])
    assert torch.equal(ids, torch.arange(4000, dtype=torch.int32))
    assert not v.any() and int(step) == 0
    lo, hi = torch.tensor(spawn["lo"]) * 2, torch.tensor(spawn["hi"]) * 2
    assert bool(((x >= lo) & (x <= hi)).all())
    assert bool((x.max(0).values - x.min(0).values > 0.95 * (hi - lo)).all())


def test_an_unknown_spawn_shape_is_refused():
    from pbfbench import harness

    conf = {"spawn": {"shape": "torus"}, "n": 10, "wall": 2.0}
    with pytest.raises(ValueError, match="torus"):
        harness.spawn(conf, 1, torch.device("cpu"))
