"""The port at the JAX package's large single-device rows
(benchmarks/bench_matrix.py:96-143: the dam break at 1M and 2M particles,
the blowup at 1M, each in a box scaled to the reference's number density),
on the CPU: their configs and derived constants against JAX, a JAX config
and checkpoint with the rows' `maxlanes`, the scenes at the scaled walls, 3
steps of a sparse dam break at those walls against the JAX dense oracle,
the cell table's overflow at 1M in both packages, the work table on the 2M
row's chunk count, the plain versions' batches, and the package data that
an installed copy needs to build its kernels."""

import dataclasses
import fnmatch
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu import config as jconfig
from pdb_sph_tpu import geometry as jgeometry
from pdb_sph_tpu.core.step import make_step as jmake_step
from pdb_sph_tpu.io import checkpoint as jcheckpoint
from pdb_sph_tpu_torch import config as tconfig
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.geometry import KernelGeometry
from pdb_sph_tpu_torch.io import checkpoint
from pdb_sph_tpu_torch.models import scenes
from pdb_sph_tpu_torch.ops import cuda_pbf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

DERIVED = ("domain_extent", "nb_cell", "nb_domain_extent", "nb_grid_width",
           "num_nb_cells", "h2", "inv_rho0", "poly6_coeff",
           "spiky_grad_coeff", "lambda_grad_coeff")

# (factory, overrides, nb_grid_width, own-chunks at own 64); the README's
# 1M command adds --grid-width 29, which leaves the neighbour grid alone
ROWS = {
    "dam1m": ("default_config", dict(n=1_000_000, wall=4.64), 51, 15_625),
    "dam1m_gw29": ("default_config", dict(n=1_000_000, wall=4.64,
                                          grid_width=29), 51, 15_625),
    "dam2m": ("default_config", dict(n=2_000_000, wall=5.85), 63, 31_250),
    "blowup1m": ("blowup_config", dict(n=1_000_000, wall=4.64), 51, 15_625),
}
# the dam column's and the standard cube's particles per unit volume at the
# reference's n and wall (80k in [0, 0.5] x [0, 2] x [0, 1])
NUMBER_DENSITY = 80_000.0
# (wall, n) of the rows, and the reference box
WALLS = ((2.0, 80_000), (4.64, 1_000_000), (5.85, 2_000_000))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "geom"}


@pytest.mark.parametrize("row", ROWS)
def test_scale_rows_match_jax(row):
    factory, kw, width, chunks = ROWS[row]
    t = getattr(tconfig, factory)(**kw)
    j = getattr(jconfig, factory)(**kw)
    assert _fields(t) == _fields(j)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name
    assert t.nb_grid_width == width and t.num_nb_cells == width ** 3
    n_pad = cuda_pbf.pad_to_chunks(t, t.n)
    assert t.geom.own == 64 and n_pad // t.geom.own == chunks
    # the cell backend's table stays capped at 4096 rows, as in JAX
    assert t.max_occupied_cells == j.max_occupied_cells == 4096


def test_row_geometry_with_maxlanes_carries_across(tmp_path):
    """The rows set JAX's maxlanes (bench_matrix.py:41), which the port's
    plan has no use for: config_from_fields drops it and keeps the rest,
    and a JAX checkpoint saved with it loads in the port."""
    jgeom = dataclasses.replace(jgeometry.geometry_from_env(),
                                maxlanes=49152)
    want_geom = KernelGeometry(**{k: getattr(jgeom, k)
                                  for k in interop.GEOM_FIELDS})
    j = jconfig.default_config(n=1_000_000, wall=4.64, geom=jgeom)
    t = interop.config_from_fields(dataclasses.asdict(j))
    assert _fields(t) == _fields(j) and t.geom == want_geom
    assert not hasattr(t.geom, "maxlanes")

    jsmall = jconfig.default_config(n=256, wall=4.64, grid_width=29,
                                    geom=jgeom)
    st = jpbf.spawn(jsmall, "dam_break", seed=3)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jsmall, st)
    cfg, state = checkpoint.load(path, device="cpu")
    assert _fields(cfg) == _fields(jsmall) and cfg.geom == want_geom
    for got, want in zip(interop.state_to_numpy(state), st):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def _region(scene, wall):
    """(centre, half-extent per axis or radius) of a scene's spawn region,
    box-relative as both packages define it."""
    if scene == "dam_break":
        return np.array([0.125, 0.5, 0.25]) * wall, np.array(
            [0.125, 0.5, 0.25]) * wall
    if scene == "standard":
        return np.full(3, 0.25 * wall), np.full(3, 0.25 * wall)
    return np.full(3, 0.5 * wall), 0.25 * wall


def _number_density(x, scene, wall):
    """Particles per unit volume in the inner half of the spawn region (the
    box of half the extents, the ball of half the radius)."""
    centre, half = _region(scene, wall)
    d = np.abs(x.astype(np.float64) - centre)
    if scene == "blowup":
        inner = np.linalg.norm(d, axis=1) < 0.5 * half
        vol = 4.0 / 3.0 * np.pi * (0.5 * half) ** 3
    else:
        inner = (d < 0.5 * half).all(axis=1)
        vol = float(np.prod(half))  # (2 * half / 2) per axis
    return inner.sum() / vol


@pytest.mark.parametrize("scene", ["dam_break", "standard", "blowup"])
def test_scenes_at_the_scaled_walls_keep_the_number_density(scene):
    """Each scene at the rows' (n, wall) lies in its box, at the number
    density it has at the reference's (n, wall) in both packages; the dam
    column and the standard cube at 80k per unit volume."""
    got = {}
    for wall, n in WALLS:
        cfg = tconfig.default_config(n=n, wall=wall)
        jcfg = jconfig.default_config(n=n, wall=wall)
        for pkg, x in (
                ("port", scenes.spawn(cfg, scene, seed=0,
                                      device="cpu").x.numpy()),
                ("jax", np.asarray(jpbf.spawn(jcfg, scene, seed=0).x))):
            assert x.shape == (n, 3)
            assert (x >= 0).all() and (x <= wall).all(), (pkg, wall)
            got[pkg, wall] = _number_density(x, scene, wall)
    ref = got["jax", 2.0]
    for key, rho in got.items():
        # counting noise at the 80k reference: ~1 % (10k in the inner box)
        assert rho == pytest.approx(ref, rel=0.03), key
    if scene != "blowup":
        for wall, n in WALLS:
            # the regions' volume is wall^3 / 8 for both scenes
            assert n / (wall ** 3 / 8) == pytest.approx(NUMBER_DENSITY,
                                                        rel=3e-3)
            assert got["port", wall] == pytest.approx(NUMBER_DENSITY,
                                                      rel=0.03)


@pytest.mark.parametrize("wall,grid_width", [(4.64, 29), (5.85, 40)])
def test_sparse_dam_at_a_scaled_wall_matches_jax_dense(wall, grid_width):
    """3 steps of a 3072-particle dam break in the rows' boxes (a sparse
    but real fill of their 51^3 and 63^3 neighbour grids): the port's
    window backend, plain torch on the CPU, against the JAX dense oracle
    from the very same particles (the repo's parity method)."""
    jcfg = jpbf.default_config(n=3072, wall=wall, grid_width=grid_width)
    st = jpbf.spawn(jcfg, "dam_break", seed=2)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    state = interop.state_from_numpy(st.x, st.v, st.ids, st.step, "cpu")
    jstep = jmake_step(jcfg, backend="dense")
    stepper = tstep.make_step(cfg, "window", device="cpu")
    for _ in range(3):
        st, state = jstep(st), stepper(state)
    x, _, ids, step = interop.state_to_numpy(state)
    assert int(step) == 3
    np.testing.assert_allclose(x[np.argsort(ids)], np.asarray(st.x),
                               rtol=1e-4, atol=1e-5)


def test_cell_table_of_the_1m_dam_overflows_as_in_jax():
    """default_config caps the cell table at 4096 rows in both packages;
    the 1M dam break occupies more cells, so the `cell` backend drops
    particles (table_overflow, and the runner's rc 2), the same count in
    both on the same particles. The window backend has no such cap."""
    from pdb_sph_tpu.ops import hashgrid as jhashgrid
    from pdb_sph_tpu_torch.ops import hashgrid

    jcfg = jconfig.default_config(n=1_000_000, wall=4.64)
    x = jpbf.spawn(jcfg, "dam_break", seed=0).x
    jsorted, jorder = jhashgrid.sort_by_cell(jcfg, jhashgrid.cell_ids(jcfg, x))
    want = int(jhashgrid.build_grid(jcfg, jsorted, jorder).n_overflow)
    cfg = tconfig.default_config(n=1_000_000, wall=4.64)
    xt = torch.from_numpy(np.asarray(x))
    sorted_cid, order = hashgrid.sort_by_cell(cfg, hashgrid.cell_ids(cfg, xt))
    assert int(torch.unique(sorted_cid).numel()) > cfg.max_occupied_cells
    got = int(hashgrid.build_grid(cfg, sorted_cid, order).n_overflow)
    assert got == want > 0


def test_work_table_stretches_segments_at_the_2m_chunk_count():
    """A plan of the 2M row's 31,250 chunks whose candidates would need
    more than ITEMS_PER_CHUNK items a chunk at the geometry's seg: the
    table takes the least longer segment that fits, as a numpy reckoning
    of its items has it (the branch a 1M blowup's spawn may take)."""
    cfg = tconfig.default_config(n=2_000_000, wall=5.85)
    chunks, seg = 31_250, cfg.geom.seg
    rng = np.random.default_rng(0)
    cand = rng.integers(0, 40 * seg, size=chunks).astype(np.int64)
    cand[rng.choice(chunks, 500, replace=False)] = 0  # empty chunks
    cand[7] = 200_000  # one heavy chunk
    spare = (cuda_pbf.ITEMS_PER_CHUNK - 1) * chunks
    want_len = max(seg, -(-int(cand.sum()) // spare))
    assert want_len > seg
    want_items = np.maximum(1, -(-cand // want_len))
    assert want_items.sum() <= cuda_pbf.ITEMS_PER_CHUNK * chunks

    seg_len, seg_prefix, total = cuda_pbf.work_table(
        cfg, torch.from_numpy(cand.astype(np.int32)))
    assert seg_len.dtype == seg_prefix.dtype == torch.int32
    assert int(total) == int(cand.sum())
    assert int(seg_len) == want_len
    np.testing.assert_array_equal(
        seg_prefix.numpy(), np.concatenate([[0], np.cumsum(want_items)]))
    # every candidate lies in an item of its own chunk
    assert (np.diff(seg_prefix.numpy()) * want_len >= cand).all()


def test_plain_batches_follow_their_own_longest_chunk():
    """The plain versions batch runs of consecutive chunks, each padded to
    its own longest chunk: one heavy chunk (16,417 candidates in the 1M
    dam break at step 60 on the card) no longer cuts every batch of the
    plan to a few chunks. The runs cover every chunk once, in order, and
    stay within the pair budget unless a chunk alone exceeds it."""
    own, budget = 64, cuda_pbf._REF_PAIRS_PER_BATCH
    rng = np.random.default_rng(1)
    lens = rng.integers(0, 3000, size=15_625)
    lens[100] = 16_417
    lens[200] = budget // own + 5  # longer than a batch on its own
    runs = cuda_pbf._chunk_batches(lens.tolist(), own)
    assert runs[0][0] == 0 and runs[-1][1] == lens.size
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    for c0, c1 in runs:
        assert c1 > c0
        assert (c1 - c0 == 1
                or (c1 - c0) * own * max(lens[c0:c1].max(), 1) <= budget)
        if c1 < lens.size:  # the next chunk would not have fit
            assert (c1 + 1 - c0) * own * max(lens[c0:c1 + 1].max(), 1) \
                > budget
    # ~20 chunks a batch at this spread, where batches sized by the plan's
    # longest chunk would hold one each
    assert len(runs) < lens.size // 15


def test_every_kernel_source_is_package_data():
    """An installed (non-editable) copy builds its kernels from the
    package's csrc/ and its native renderer from render/cpp/: every file
    there must match a package-data pattern of pyproject.toml."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    port = ROOT / "pdb_sph_tpu_torch"
    files = [p for d in ("csrc", "render/cpp") for p in (port / d).iterdir()
             if p.is_file()]
    assert any(p.suffix == ".cuh" for p in files)
    for path in files:
        rel = path.relative_to(ROOT)
        matched = False
        for pkg, patterns in data.items():
            pkg_dir = ROOT / Path(*pkg.split("."))
            if not path.is_relative_to(pkg_dir):
                continue
            sub = path.relative_to(pkg_dir).as_posix()
            matched |= any(fnmatch.fnmatch(sub, p) for p in patterns)
        assert matched, f"{rel} matches no package-data pattern"
