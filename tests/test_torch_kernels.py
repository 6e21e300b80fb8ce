"""The port's density and project passes against the JAX package's, and
the FP32 kernels' cull.

On the CPU the port's wrappers run their plain torch versions, which the
CUDA kernels are held against on the card (chip_smoke.py). Here they meet
the JAX Pallas kernels in interpret mode and the JAX dense oracle, on the
same cell-sorted n = 300 standard-scene positions (300 % 64 != 0, so the
last chunk mixes real and padding rows). Only the first n rows compare.

The cull's plain torch mirror (`cuda_pbf.cull_groups`,
`cull_survivors`) keeps every pair within h, here on the benchmark's dam
spawn and on planted pairs at h and at each group's box corners; its
four groups are the k-d split the kernels make, and evaluate at least
1.2x fewer pairs than two halves on the 80k spawn. The tests marked
`card` hold the culled kernels against the plain versions and the mirror
on a card, with

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" \
        -m card tests/test_torch_kernels.py

and skip without one; JAX is imported only where the JAX tests need it,
since the card's machine does not have it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.core.step import sort_cells
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid
from pdb_sph_tpu_torch.ops.smoothing import f32

torch.set_num_threads(1)

N = 300
LAM_TOL = dict(rtol=1e-5, atol=1e-7)
POS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    """Sorted positions, the port's plan, and the JAX outputs (built once:
    the interpret-mode passes dominate this file's time)."""
    import jax.numpy as jnp

    import pdb_sph_tpu as jpbf
    from pdb_sph_tpu.ops import dense as jdense
    from pdb_sph_tpu.ops import hashgrid as jhash
    from pdb_sph_tpu.ops import pallas_pbf

    # gb=2 cuts the Pallas grid to n_pad = 384 (default 1024): the same
    # kernels, a third of the interpret-mode time
    jcfg = jpbf.default_config(
        n=N, geom=dataclasses.replace(jpbf.KernelGeometry(), gb=2))
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    x = jpbf.spawn(jcfg, "standard", seed=2).x
    n_pad_j = pallas_pbf.pad_to_chunks(jcfg, N)
    cid = jhash.cell_ids(jcfg, x)
    cid_pad = jnp.concatenate(
        [cid, jnp.full((n_pad_j - N,), jcfg.num_nb_cells, jnp.int32)])
    sc, order = jhash.sort_by_cell(jcfg, cid_pad)
    ps = np.asarray(x)[np.asarray(order[:N])]
    plan_j = pallas_pbf.build_plan(jcfg, sc)

    pT = pallas_pbf.make_pT(jcfg, jnp.asarray(ps), n_pad_j)
    p4_j = pallas_pbf._p4_from_pT(jcfg, pT)
    lam_j = pallas_pbf.density_pass(jcfg, pT, p4_j, plan_j, interpret=True)
    pT = pT.at[:, 3].set(lam_j[:, 0])
    p4_j = pallas_pbf.splice_lambda(jcfg, p4_j, lam_j, n_pad_j)
    proj_j = pallas_pbf.project_pass(jcfg, pT, p4_j, plan_j, interpret=True)

    lam_dense = jdense.density_lambda_dense(jcfg, jnp.asarray(ps))
    moved_dense = jnp.asarray(ps) + jdense.project_dense(
        jcfg, jnp.asarray(ps), lam_dense)

    # the port's own sort and plan of the same (already sorted) positions
    n_pad = cuda_pbf.pad_to_chunks(cfg, N)
    tcid = hashgrid.cell_ids(cfg, torch.from_numpy(ps))
    assert (tcid[1:] >= tcid[:-1]).all()
    plan = cuda_pbf.build_plan(
        cfg, torch.cat([tcid, tcid.new_full((n_pad - N,),
                                            cfg.num_nb_cells)]))
    return dict(cfg=cfg, ps=ps, plan=plan, n_pad=n_pad,
                lam_pallas=np.asarray(lam_j)[:N, 0],
                proj_pallas=np.asarray(proj_j)[:N, :3],
                lam_dense=np.asarray(lam_dense),
                moved_dense=np.asarray(moved_dense))


def _p4(case, lam=None):
    p4 = torch.zeros((case["n_pad"], 4), dtype=torch.float32)
    p4[:N, :3] = torch.tensor(case["ps"])
    if lam is not None:
        p4[:N, 3] = torch.tensor(lam)
    return p4


@pytest.mark.parametrize("ref", ["lam_pallas", "lam_dense"])
def test_density_pass_matches_jax(case, ref):
    p4 = _p4(case)
    out = cuda_pbf.density_pass(case["cfg"], p4, case["plan"], N)
    np.testing.assert_allclose(out[:N, 3].numpy(), case[ref], **LAM_TOL)
    assert torch.equal(out[:N, :3], p4[:N, :3])
    assert not out[N:].any()


@pytest.mark.parametrize("lam,ref", [("lam_pallas", "proj_pallas"),
                                     ("lam_dense", "moved_dense")])
def test_project_pass_matches_jax(case, lam, ref):
    p4 = _p4(case, case[lam])
    out = cuda_pbf.project_pass(case["cfg"], p4, case["plan"], N)
    np.testing.assert_allclose(out[:N, :3].numpy(), case[ref], **POS_TOL)
    assert torch.equal(out[:N, 3], p4[:N, 3])


def test_passes_write_into_out_and_ping_pong(case):
    """With out= the passes fill the caller's buffer, and one solve
    iteration equals density then project."""
    cfg, plan = case["cfg"], case["plan"]
    a, b = _p4(case), torch.zeros((case["n_pad"], 4))
    assert cuda_pbf.density_pass(cfg, a, plan, N, out=b) is b
    want = cuda_pbf.project_pass(cfg, b, plan, N)
    cfg1 = dataclasses.replace(cfg, solver_iters=1)
    got = cuda_pbf.solve(cfg1, torch.from_numpy(case["ps"]), plan)
    assert torch.equal(got, want[:N, :3])


def test_wrappers_reject_bad_inputs_and_other_devices(case):
    cfg, plan = case["cfg"], case["plan"]
    p4 = _p4(case)
    with pytest.raises(ValueError):  # wrong dtype
        cuda_pbf.density_pass(cfg, p4.double(), plan, N)
    with pytest.raises(ValueError):  # n_pad not a multiple of own
        cuda_pbf.density_pass(cfg, p4[:-1], plan, N)
    with pytest.raises(ValueError):  # out aliasing the input
        cuda_pbf.project_pass(cfg, p4, plan, N, out=p4)
    with pytest.raises(ValueError):  # not contiguous
        cuda_pbf.project_pass(cfg, torch.zeros((4, case["n_pad"])).T,
                              plan, N)
    # neither the CPU nor a CUDA tensor: no kernel, no plain fallback
    meta = cuda_pbf.WindowPlan(plan.ranges.to("meta"),
                               plan.n_overflow.to("meta"))
    before = dict(cuda_pbf.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_pbf.density_pass(cfg, p4.to("meta"), meta, N)
    assert cuda_pbf.LAUNCHES == before


def test_header_edit_changes_the_build_hash(tmp_path, monkeypatch):
    """The library's name hashes the csrc headers too, so an edit of a
    shared header rebuilds every source that includes it."""
    from pdb_sph_tpu_torch.utils import cuda_build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    sources = [tmp_path / "a.cu"]
    first = cuda_build._source_hash(sources)
    assert cuda_build._source_hash(sources) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = cuda_build._source_hash(sources)
    assert edited != first
    (tmp_path / "g.cuh").write_text("// new\n")
    assert cuda_build._source_hash(sources) not in (first, edited)
    cmd = cuda_build.compile_command("nvcc", sources[0], tmp_path / "a.o")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)


def _c_launchers() -> dict:
    """extern "C" launch_* name -> ctypes argtypes, read from csrc."""
    import ctypes
    import re

    from pdb_sph_tpu_torch.utils import cuda_build

    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in cuda_build.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (launch_\w+)\(([^)]*)\)', text):
            found[name] = tuple(
                kinds[re.sub(r"\s*\w+$", "", p.strip())]
                for p in params.split(","))
    return found


def test_signatures_match_the_c_launchers():
    """Every launcher's ctypes argtypes follow its C declaration, argument
    for argument, so a pointer is never cut to an int; the FP32 launchers
    take the evaluated-pair counter, a pointer, just before the stream,
    the tensor-core ones end on their last float constant, finalize's
    on its last float constant and the strict switch, and the plan's two
    on their output pointers."""
    import ctypes

    from pdb_sph_tpu_torch.utils import cuda_build

    assert _c_launchers() == cuda_build.SIGNATURES
    for name, args in cuda_build.SIGNATURES.items():
        tail = args[-3:]
        if name == "launch_finalize":
            assert tail == (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
        elif name in ("launch_plan_windows", "launch_work_table"):
            assert tail == (ctypes.c_void_p,) * 3, name
        elif name.endswith("_tc"):
            assert tail[1:] == (ctypes.c_float, ctypes.c_void_p), name
        else:
            assert tail == (ctypes.c_float, ctypes.c_void_p,
                            ctypes.c_void_p), name


# ---------------------------------------------------------------------------
# the cull
# ---------------------------------------------------------------------------

def _bench_dam(n: int, own: int, seed: int = 7):
    """(cfg, p4, plan) of the benchmark's dam spawn (the dam80k.frames
    cell's configuration and `harness.spawn`) at n particles, cell-sorted,
    in the geometry of `own`."""
    from pbfbench import harness

    conf = harness.find_cell("dam80k.frames").config | {"n": n}
    cfg = harness.sim_config(conf, {"own": own})
    x = harness.spawn(conf, seed, torch.device("cpu"))[0]
    return (cfg, *_sorted_plan(cfg, x))


def _sorted_plan(cfg, x):
    """(p4, plan) of positions x in the step's cell sort."""
    sorted_cid, order = sort_cells(cfg, hashgrid.cell_ids(cfg, x))
    p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                     device=x.device)
    p4[:x.shape[0], :3] = x[order]
    return p4, cuda_pbf.build_plan(cfg, sorted_cid)


def _unkept_pairs_within_h(cfg, p4, plan, n):
    """(pairs within h that the cull dropped, pairs within h, pairs
    kept): a pair is within h when its rd2 in float32, or its exact rd2
    less 2^-21 of it (any rounding of the kernels' rd2), is below h^2."""
    own = cfg.geom.own
    h2 = f32(cfg.h2)
    dropped = within = kept = 0
    for c0, group, keep, idx, mask in cuda_pbf.cull_survivors(cfg, p4, plan,
                                                              n):
        b, length = idx.shape
        rows = p4[c0 * own:(c0 + b) * own, :3].reshape(b, own, 1, 3)
        cand = p4[idx][:, None, :, :3]
        d = rows - cand
        rd2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        exact = ((rows.double() - cand.double()) ** 2).sum(-1)
        real = (torch.arange(c0 * own, (c0 + b) * own) < n).view(b, own, 1)
        near = ((rd2 < h2) | (exact * (1 - 2.0 ** -21) < h2)) & real \
            & mask[:, None, :]
        mine = keep.gather(1, group[:, :, None].expand(b, own, length))
        dropped += int((near & ~mine).sum())
        within += int(near.sum())
        kept += int((mine & real & mask[:, None, :]).sum())
    return dropped, within, kept


@pytest.mark.parametrize("own", [32, 64, 128, 256])
def test_the_cull_keeps_every_pair_within_h_of_the_spawn(own):
    """On the benchmark's dam spawn (n = 2,000: the last chunk mixes rows
    below n and past it) no pair within h is dropped, while the cull drops
    most candidates of the plan; cull_pair_evals counts the kept pairs of
    every row, rows past n too, as the kernels evaluate them."""
    n = 2000
    cfg, p4, plan = _bench_dam(n, own)
    dropped, within, kept = _unkept_pairs_within_h(cfg, p4, plan, n)
    assert dropped == 0 and within > n
    evals = cuda_pbf.cull_pair_evals(cfg, p4, plan, n)
    assert kept <= evals < int(plan.n_candidates) * own
    if own >= 64:  # four groups: the quarters' boxes cut ~2.3x at this size
        assert evals * 2 < int(plan.n_candidates) * own


def test_the_cull_keeps_planted_pairs_at_h_and_at_a_box_corner():
    """Rows fill four small cubes, one a group of the k-d split (the
    chunk's longest axis is x, each half's y), whose two far corners are
    rows; candidates sit at h (1 + k 2^-23), k = -3 .. 3, from each
    group's corner rows, along an axis and along the diagonal, each also
    one float32 step either way; and at 1.01 h from each group's box, past
    both of its corners. Every pair within h survives its group's cull
    (the self pairs too), and the far candidates are dropped."""
    own, h = 64, 0.1
    cfg = dataclasses.replace(_bench_dam(64, own)[0], n=own)
    groups = cfg.geom.cull_groups
    gen = torch.Generator().manual_seed(3)
    side = 0.06
    rows = torch.empty((own, 3), dtype=torch.float64)
    corners = []
    for g in range(groups):
        lo = torch.tensor([1.0 + 0.5 * (g // 2), 1.0 + 0.3 * (g % 2), 1.0],
                          dtype=torch.float64)
        cube = lo + side * torch.rand((own // groups, 3), generator=gen,
                                      dtype=torch.float64)
        cube[0], cube[-1] = lo, lo + side
        rows[g::groups] = cube  # the groups' rows interleaved in the chunk
        corners += [(g, -1.0), (own - groups + g, 1.0)]
    rows = rows.float()
    group, box_lo, box_hi = cuda_pbf.cull_groups(
        cfg, torch.cat([rows, torch.zeros((own, 1))], 1), own)
    assert torch.equal(group[0], torch.arange(own) % groups)
    cands = []
    for row, sign in corners:
        corner = rows[row]
        for k in range(-3, 4):
            reach = h * (1 + k * 2.0 ** -23)
            for step in (torch.eye(3, dtype=torch.float64),
                         torch.ones((1, 3), dtype=torch.float64) / 3 ** 0.5):
                c = (corner.double() + sign * reach * step).float()
                cands += [c, torch.nextafter(c, c + sign),
                          torch.nextafter(c, c - sign)]
    for g in range(groups):
        cands.append((box_lo[0, g] - 1.01 * h)[None])
        cands.append((box_hi[0, g] + 1.01 * h)[None])
    cands = torch.cat(cands)
    m = cands.shape[0]
    n_pad = -(-(own + m) // own) * own
    p4 = torch.zeros((n_pad, 4))
    p4[:own, :3] = rows
    p4[own:own + m, :3] = cands
    keeps = []
    for first in (0, own):  # every candidate, then the planted ones alone
        ranges = torch.zeros((n_pad // own, 9, 2), dtype=torch.int32)
        ranges[0, 0] = torch.tensor([first, own + m])
        plan = cuda_pbf.WindowPlan(ranges,
                                   torch.zeros((), dtype=torch.int32))
        dropped, within, _ = _unkept_pairs_within_h(cfg, p4, plan, own + m)
        assert dropped == 0 and within > 0
        keeps.append(next(cuda_pbf.cull_survivors(cfg, p4, plan,
                                                  own + m))[2][0])
    assert keeps[0][:, :own].any(dim=0).all()
    assert not keeps[1][:, -2 * groups:].any()


def _kd_groups_plain(rows, n):
    """Chunk row -> group of one chunk's (own, 3) rows (rows from n on not
    written), by Python sorts: the rows ordered by (written or not, the
    coordinate along the longest axis of the written rows' box, the row),
    cut at the middle; each half ordered likewise along the longest axis
    of its own written rows' box, cut at its middle. With coordinates of
    few mantissa bits the kernels' keys order them the same way."""
    rows = rows.tolist()
    own = len(rows)

    def longest(part):
        pts = [rows[t] for t in part if t < n]
        ext = [max(p[a] for p in pts) - min(p[a] for p in pts)
               for a in range(3)]
        axis = 1 if ext[1] > ext[0] else 0
        return 2 if ext[2] > max(ext[0], ext[1]) else axis

    def ordered(part):
        axis = longest(part)
        return sorted(part, key=lambda t: (t >= n, rows[t][axis] if t < n
                                           else 0.0, t))

    first = ordered(range(own))
    group = [0] * own
    for h, half in enumerate((first[: own // 2], first[own // 2:])):
        for rank, t in enumerate(ordered(half)):
            group[t] = 2 * h + rank // (own // 4)
    return group


def test_the_four_groups_are_the_k_d_split_of_the_chunk():
    """Two chunks of 64 rows on a grid of 1/16 (many ties): rows of small
    x span [0, 0.75] in y, the others [0, 0.75] in z, so the chunk is cut
    along x, one half along y and the other along z; in the second chunk
    the last 12 rows are past n, each at z 5 (were they boxed, z would be
    every cut's axis). The mirror's groups are the plain sorts' (ties by
    the row), a quarter of the ranks each, 16 / 16 / 16 / 16, rows past n
    last in the last group, and each box the group's written rows'."""
    own = 64
    cfg = dataclasses.replace(_bench_dam(64, own)[0], n=2 * own - 12)
    assert cfg.geom.cull_groups == 4
    gen = torch.Generator().manual_seed(11)
    grid = torch.randint(0, 5, (2 * own, 3), generator=gen).double() / 16
    left = torch.rand((2 * own,), generator=gen) < 0.5
    x = torch.where(left, 1.0, 2.0) + grid[:, 0]
    y = 1.0 + torch.where(left, 3 * grid[:, 1], grid[:, 1])
    z = 1.0 + torch.where(left, grid[:, 2], 3 * grid[:, 2])
    rows = torch.stack([x, y, z], 1).float()
    rows[cfg.n:, 2] = 5.0
    p4 = torch.cat([rows, torch.zeros((2 * own, 1))], 1)
    group, lo, hi = cuda_pbf.cull_groups(cfg, p4, cfg.n)
    for c in range(2):
        n_c = min(own, cfg.n - c * own)
        chunk = rows[c * own:(c + 1) * own]
        assert group[c].tolist() == _kd_groups_plain(chunk, n_c)
        assert torch.equal(torch.bincount(group[c], minlength=4),
                           torch.full((4,), own // 4))
        assert (group[c, n_c:] == 3).all()
        for g in range(4):
            mine = chunk[:n_c][group[c, :n_c] == g]
            assert torch.equal(lo[c, g], mine.amin(0))
            assert torch.equal(hi[c, g], mine.amax(0))


def test_four_groups_cut_the_evaluations_of_the_80k_spawn():
    """On the benchmark's 80k dam spawn the four groups evaluate at least
    1.2x fewer pairs than two groups, the halves of the first cut with
    their own boxes, on the same plan."""
    n, own = 80_000, 64
    cfg, p4, plan = _bench_dam(n, own)
    four = cuda_pbf.cull_pair_evals(cfg, p4, plan, n)
    group = cuda_pbf.cull_groups(cfg, p4, n)[0]
    half = group // 2
    rows = p4[:, :3].view(-1, own, 3)
    valid = (torch.arange(p4.shape[0]) < n).view(-1, own, 1)
    inf = torch.tensor(float("inf"))
    lo = torch.stack([torch.where(valid & (half == h)[..., None], rows,
                                  inf).amin(1) for h in (0, 1)], 1)
    hi = torch.stack([torch.where(valid & (half == h)[..., None], rows,
                                  -inf).amax(1) for h in (0, 1)], 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_pbf, "cull_groups", lambda *a: (half, lo, hi))
        two = sum(int(keep.sum()) for _, _, keep, _, _ in
                  cuda_pbf.cull_survivors(cfg, p4, plan, n)) * (own // 2)
    assert two >= 1.2 * four


def test_the_step_gives_its_counter_to_the_density_passes(monkeypatch):
    """The window step hands Stepper.counters["pair_evals"] to every
    density pass of its solve and to no project pass."""
    from pdb_sph_tpu_torch import default_config, spawn
    from pdb_sph_tpu_torch.core import step as tstep

    seen = {"density": [], "project": []}
    for name, key in (("density_pass", "density"),
                      ("project_pass", "project")):
        real = getattr(cuda_pbf, name)

        def wrapped(*a, _real=real, _key=key, **kw):
            seen[_key].append(kw.get("evals"))
            return _real(*a, **{k: v for k, v in kw.items()
                                if k != "evals"})
        monkeypatch.setattr(cuda_pbf, name, wrapped)
    cfg = default_config(n=256)
    stepper = tstep.Stepper(cfg, "window", device="cpu")
    stepper.step(spawn(cfg, "dam_break", seed=0, device="cpu"))
    counter = stepper.counters["pair_evals"]
    assert len(seen["density"]) == cfg.solver_iters
    assert all(e is counter for e in seen["density"])
    assert seen["project"] == [None] * cfg.solver_iters
    assert int(counter) == 0  # the plain versions count nothing


# ---------------------------------------------------------------------------
# the culled kernels on a card
# ---------------------------------------------------------------------------

# (scene, n, wall, the step of the scene the state is taken at)
CARD_STATES = {"dam80k@60": ("dam_break", 80_000, None, 60),
               "dam80k@480": ("dam_break", 80_000, None, 480),
               "dam1m@60": ("dam_break", 1_000_000, 4.64, 60),
               "blowup1m@8": ("blowup", 1_000_000, 4.64, 8)}


@pytest.fixture(scope="module")
def card_states():
    """name -> the state's positions on the card, made on first use by the
    port's graph rollout from the scene's seed-0 spawn; or skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from pdb_sph_tpu_torch import (blowup_config, default_config,
                                   make_rollout, spawn)

    made = {}

    def get(name):
        if name not in made:
            scene, n, wall, steps = CARD_STATES[name]
            config = blowup_config if scene == "blowup" else default_config
            cfg = config(n=n, **({} if wall is None else {"wall": wall}))
            dev = torch.device("cuda", 0)
            st = spawn(cfg, scene, seed=0, device=dev)
            made[name] = (cfg, make_rollout(cfg, "window", steps,
                                            device=dev)(st).x)
        return made[name]
    return get


@pytest.mark.card
@pytest.mark.parametrize("own", [32, 64, 128])
@pytest.mark.parametrize("state", list(CARD_STATES))
def test_the_culled_kernels_on_the_card(card_states, state, own):
    """K1 lambda, K2 and K1 rho on the card: within LAM_TOL / POS_TOL of
    their plain versions, two launches bitwise equal, the scratch's
    counters back at 0, and the evaluated-pair counter equal to the plain
    torch mirror of the cull on the same plan."""
    cfg, x = card_states(state)
    cfg = dataclasses.replace(cfg, geom=dataclasses.replace(cfg.geom,
                                                            own=own))
    n = x.shape[0]
    p4, plan = _sorted_plan(cfg, x)
    scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], p4.device)
    lam = cuda_pbf.density_pass(cfg, p4, plan, n, scratch=scratch)
    want_evals = cuda_pbf.cull_pair_evals(cfg, p4, plan, n)
    assert want_evals < int(plan.n_candidates) * own
    passes = (
        (cuda_pbf.density_pass, cuda_pbf.density_pass_ref, p4, [3], LAM_TOL),
        (cuda_pbf.project_pass, cuda_pbf.project_pass_ref, lam, [0, 1, 2],
         POS_TOL),
        (cuda_pbf.density_rho, cuda_pbf.density_rho_ref, p4, [3],
         dict(rtol=LAM_TOL["rtol"], atol=0.0)))
    for kernel, plain, src, cols, tol in passes:
        evals = torch.zeros((), dtype=torch.int64, device=p4.device)
        got = kernel(cfg, src, plan, n, scratch=scratch, evals=evals)
        again = kernel(cfg, src, plan, n, scratch=scratch)
        want = plain(cfg, src, plan, n)
        torch.cuda.synchronize()
        assert torch.equal(got, again), kernel.__name__
        torch.testing.assert_close(got[:n, cols], want[:n, cols], **tol)
        assert int(evals) == want_evals, kernel.__name__
        assert not scratch.counters.any()
