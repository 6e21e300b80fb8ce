"""The port's density and project passes against the JAX package's, and
the FP32 kernels' cull.

On the CPU the port's wrappers run their plain torch versions, which the
CUDA kernels are held against on the card (chip_smoke.py). Here they meet
the JAX Pallas kernels in interpret mode and the JAX dense oracle, on the
same cell-sorted n = 300 standard-scene positions (300 % 64 != 0, so the
last chunk mixes real and padding rows). Only the first n rows compare.

The cull's plain torch mirror (`cuda_pbf.cull_survivors`) keeps every
pair within h, here on the benchmark's dam spawn and on planted pairs at
h and at a box corner. The tests marked `card` hold the culled kernels
against the plain versions and the mirror on a card, with

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
    if own >= 64:  # two groups: the halves' boxes cut ~1.8x at this size
        assert evals * 1.5 < int(plan.n_candidates) * own


def test_the_cull_keeps_planted_pairs_at_h_and_at_a_box_corner():
    """Rows fill a cube whose two far corners are rows; candidates sit at
    h (1 + k 2^-23), k = -3 .. 3, from those corner rows, along an axis
    and along the diagonal, each also one float32 step either way; and at
    1.01 h from each box. Every pair within h survives its group's cull
    (the self pairs too), and the far candidates are dropped."""
    own, h = 64, 0.1
    cfg = dataclasses.replace(_bench_dam(64, own)[0], n=own)
    gen = torch.Generator().manual_seed(3)
    lo, hi = 1.0, 1.06
    rows = lo + (hi - lo) * torch.rand((own, 3), generator=gen)
    rows[5] = lo
    rows[40] = hi
    rows = rows.float()
    cands = []
    for corner, sign in ((rows[5], -1.0), (rows[40], 1.0)):
        for k in range(-3, 4):
            reach = h * (1 + k * 2.0 ** -23)
            for step in (torch.eye(3, dtype=torch.float64),
                         torch.ones((1, 3), dtype=torch.float64) / 3 ** 0.5):
                c = (corner.double() + sign * reach * step).float()
                cands += [c, torch.nextafter(c, c + sign),
                          torch.nextafter(c, c - sign)]
    _, box_lo, box_hi = cuda_pbf.cull_groups(
        cfg, torch.cat([rows, torch.zeros((own, 1))], 1), own)
    for g in (0, 1):
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
    assert not keeps[1][:, -4:].any()


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

# (scene rows: n, wall, the step of the dam break the state is taken at)
CARD_STATES = {"dam80k@60": (80_000, None, 60),
               "dam80k@480": (80_000, None, 480),
               "dam1m@60": (1_000_000, 4.64, 60)}


@pytest.fixture(scope="module")
def card_states():
    """name -> the state's positions on the card, made on first use by the
    port's graph rollout from the seed-0 dam spawn; or skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from pdb_sph_tpu_torch import default_config, make_rollout, spawn

    made = {}

    def get(name):
        if name not in made:
            n, wall, steps = CARD_STATES[name]
            cfg = default_config(n=n, **({} if wall is None
                                         else {"wall": wall}))
            dev = torch.device("cuda", 0)
            st = spawn(cfg, "dam_break", seed=0, device=dev)
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
