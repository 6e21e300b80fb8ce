"""The pair kernels' work split on the CPU: the plan's work table, the
segmented sums of the FP32 and tensor-core forms against the unsegmented
ones and the JAX package's, the Stepper's scratch, and the geometry's
segment length in checkpoints.

Each test runs at two segment lengths: SMALL, which cuts the blowup
state's chunks into several segments, and WHOLE, one segment per chunk.
The CUDA kernels are held to the same split on the card (chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import make_step as jmake_step
from pdb_sph_tpu.ops import dense as jdense
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu.ops import pallas_pbf
from pdb_sph_tpu_torch import KernelGeometry, default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.io import checkpoint
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

torch.set_num_threads(1)

N = 300
SMALL, WHOLE = 32, 1 << 20
SEGS = [SMALL, WHOLE]
LAM_ATOL, LAM_RTOL = 1e-8, 1e-4
POS_ATOL = 1e-5
RHO_RTOL = 1e-5
# the tensor-core forms: pass -> form -> the geometry's switches
TC_SWITCHES = {
    "density": {"rd2": dict(mxu_rd2=True), "sum": dict(mxu_sum=True),
                "rd2_sum": dict(mxu_rd2=True, mxu_sum=True)},
    "project": {"proj": dict(mxu_proj=True), "sum": dict(mxu_sum=True),
                "proj_sum": dict(mxu_proj=True, mxu_sum=True)},
}
TC_FORMS = [(p, f) for p, forms in TC_SWITCHES.items() for f in forms]


def _cfg(seg, jcfg=None):
    base = interop.config_from_fields(dataclasses.asdict(
        jcfg if jcfg is not None else jpbf.default_config(n=N)))
    return dataclasses.replace(base, geom=dataclasses.replace(base.geom,
                                                              seg=seg))


@pytest.fixture(scope="module")
def blowup():
    """A sorted blowup state at N, the JAX interpret-mode passes on it, and
    its cell ids padded by two all-pad chunks."""
    jcfg = jpbf.default_config(
        n=N, geom=dataclasses.replace(jpbf.KernelGeometry(), gb=2))
    x = jpbf.spawn(jcfg, "blowup", seed=2).x
    n_pad_j = pallas_pbf.pad_to_chunks(jcfg, N)
    cid = jhash.cell_ids(jcfg, x)
    cid_pad = jnp.concatenate(
        [cid, jnp.full((n_pad_j - N,), jcfg.num_nb_cells, jnp.int32)])
    sc, order = jhash.sort_by_cell(jcfg, cid_pad)
    ps = np.asarray(x)[np.asarray(order[:N])]
    plan_j = pallas_pbf.build_plan(jcfg, sc)
    pT0 = pallas_pbf.make_pT(jcfg, jnp.asarray(ps), n_pad_j)
    p4_j = pallas_pbf._p4_from_pT(jcfg, pT0)
    lam_j = pallas_pbf.density_pass(jcfg, pT0, p4_j, plan_j, interpret=True)
    pT = pT0.at[:, 3].set(lam_j[:, 0])
    p4_j = pallas_pbf.splice_lambda(jcfg, p4_j, lam_j, n_pad_j)
    proj_j = pallas_pbf.project_pass(jcfg, pT, p4_j, plan_j, interpret=True)

    cfg = _cfg(SMALL, jcfg)
    tcid = hashgrid.cell_ids(cfg, torch.from_numpy(ps))
    pad = cuda_pbf.pad_to_chunks(cfg, N) + 2 * cfg.geom.own - N
    sorted_cid = torch.cat([tcid, tcid.new_full((pad,), cfg.num_nb_cells)])
    return dict(jcfg=jcfg, ps=ps, sorted_cid=sorted_cid,
                lam=np.asarray(lam_j)[:N, 0],
                moved=np.asarray(proj_j)[:N, :3],
                rho=np.asarray(jdense.density_dense(jcfg, jnp.asarray(ps))),
                jax_inputs=(plan_j, pT0, pT, lam_j, n_pad_j))


@pytest.fixture(scope="module")
def tc_jax(blowup):
    """JAX's interpret-mode passes on the blowup state with each
    tensor-core form's switches: the density forms' lambda, and the
    project forms' positions from the FP32 lambda of `blowup`."""
    jcfg = blowup["jcfg"]
    plan_j, pT, pT_lam, lam_j, n_pad_j = blowup["jax_inputs"]
    out = {}
    for (kind, form) in TC_FORMS:
        c = dataclasses.replace(jcfg, geom=dataclasses.replace(
            jcfg.geom, **TC_SWITCHES[kind][form]))
        if kind == "density":
            lam = pallas_pbf.density_pass(c, pT, pallas_pbf._p4_from_pT(c, pT),
                                          plan_j, interpret=True)
            out[kind, form] = np.asarray(lam)[:N, 0]
        else:
            p4 = pallas_pbf.splice_lambda(
                c, pallas_pbf._p4_from_pT(c, pT_lam), lam_j, n_pad_j)
            moved = pallas_pbf.project_pass(c, pT_lam, p4, plan_j,
                                            interpret=True)
            out[kind, form] = np.asarray(moved)[:N, :3]
    return out


def _p4(case, n_pad, lam=None):
    p4 = torch.zeros((n_pad, 4), dtype=torch.float32)
    p4[:N, :3] = torch.from_numpy(case["ps"])
    if lam is not None:
        p4[:N, 3] = torch.from_numpy(np.array(lam))
    return p4


@pytest.mark.parametrize("seg", SEGS)
def test_work_table_covers_each_chunk_once_in_order(blowup, seg):
    """Item k of chunk c covers positions [k L, (k + 1) L) of the chunk's
    concatenated windows (L = seg_len): together every candidate once, in
    order, no item over the geometry's seg, one item per all-pad chunk."""
    cfg = _cfg(seg, blowup["jcfg"])
    plan = cuda_pbf.build_plan(cfg, blowup["sorted_cid"])
    prefix = plan.seg_prefix.numpy()
    length = int(plan.seg_len)
    cand = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1).numpy()
    chunks = cand.shape[0]
    assert plan.seg_prefix.dtype == plan.seg_len.dtype == torch.int32
    assert prefix.shape == (chunks + 1,) and prefix[0] == 0
    assert prefix[-1] <= cuda_pbf.ITEMS_PER_CHUNK * chunks
    assert length == seg  # the scratch's capacity does not bind here
    if seg == SMALL:
        assert (np.diff(prefix) > 2).sum() > chunks // 2
    for c in range(chunks):
        items = prefix[c + 1] - prefix[c]
        pieces = [(k * length, min((k + 1) * length, cand[c]))
                  for k in range(items)]
        covered = [p for a, b in pieces for p in range(a, b)]
        assert covered == list(range(cand[c])), f"chunk {c}"
        assert all(0 < b - a <= seg for a, b in pieces) or cand[c] == 0
        if cand[c] == 0:
            assert items == 1, f"all-pad chunk {c} has {items} items"
    assert (cand[-2:] == 0).all()


@pytest.mark.parametrize("seg", SEGS)
def test_work_table_takes_longer_segments_at_capacity(seg):
    """Candidates that would need more items than the scratch holds get
    longer segments, the least length L with chunks + total / L within the
    capacity, so every candidate still lies in an item."""
    cfg = default_config(n=64 * 5, geom=KernelGeometry(seg=seg))
    cand = torch.tensor([0, 3, seg * 100, 7 * seg + 1, 1], dtype=torch.int32)
    seg_len, prefix, got_total = cuda_pbf.work_table(cfg, cand)
    capacity = cuda_pbf.ITEMS_PER_CHUNK * 5
    total = int(cand.long().sum())
    assert got_total.dtype == torch.int64 and int(got_total) == total
    assert int(seg_len) == max(seg, -(-total // (capacity - 5))) > seg
    items = torch.clamp(-(-cand.long() // int(seg_len)), min=1)
    assert prefix.tolist() == [0] + items.cumsum(0).tolist()
    assert int(prefix[-1]) <= capacity
    assert (items * int(seg_len) >= cand.long()).all()


@pytest.mark.parametrize("seg", SEGS)
def test_split_sums_match_unsplit_and_jax(blowup, seg):
    """The kernels' split (segment partial sums added in segment order)
    against the plain unsplit sums and the JAX interpret-mode passes."""
    cfg = _cfg(seg, blowup["jcfg"])
    plan = cuda_pbf.build_plan(cfg, blowup["sorted_cid"])
    n_pad = blowup["sorted_cid"].shape[0]
    p4 = _p4(blowup, n_pad)

    lam = {s: cuda_pbf.density_pass_ref(cfg, p4, plan, N, split=s)[:N, 3]
           for s in (True, False)}
    for want in (lam[False].numpy(), blowup["lam"]):
        np.testing.assert_allclose(lam[True].numpy(), want, rtol=LAM_RTOL,
                                   atol=LAM_ATOL)

    rho = {s: cuda_pbf.density_rho_ref(cfg, p4, plan, N, split=s)[:N, 3]
           for s in (True, False)}
    for want in (rho[False].numpy(), blowup["rho"]):
        np.testing.assert_allclose(rho[True].numpy(), want, rtol=RHO_RTOL)

    p4l = _p4(blowup, n_pad, blowup["lam"])
    moved = {s: cuda_pbf.project_pass_ref(cfg, p4l, plan, N, split=s)
             for s in (True, False)}
    assert torch.equal(moved[True][:N, 3], p4l[:N, 3])
    for want in (moved[False][:N, :3].numpy(), blowup["moved"]):
        np.testing.assert_allclose(moved[True][:N, :3].numpy(), want,
                                   rtol=0, atol=POS_ATOL)
    if seg == WHOLE:  # one segment per chunk: the plain sum itself
        assert torch.equal(lam[True], lam[False])
        assert torch.equal(rho[True], rho[False])
        assert torch.equal(moved[True], moved[False])


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind,form", TC_FORMS)
def test_tc_split_sums_match_unsplit_and_jax(blowup, tc_jax, kind, form,
                                             seg):
    """The tensor-core forms' split as their kernels take it (the row sums,
    and delta-p's split product, per segment, added in segment order)
    against the plain unsplit form and JAX's interpret-mode pass with the
    same switches."""
    base = _cfg(seg, blowup["jcfg"])
    cfg = dataclasses.replace(base, geom=dataclasses.replace(
        base.geom, **TC_SWITCHES[kind][form]))
    plan = cuda_pbf.build_plan(cfg, blowup["sorted_cid"])
    n_pad = blowup["sorted_cid"].shape[0]
    if kind == "density":
        p4 = _p4(blowup, n_pad)
        got = {s: cuda_pbf.density_pass_ref(cfg, p4, plan, N, split=s)
               for s in (True, False)}
        kept, cols, tol = slice(0, 3), slice(3, 4), dict(rtol=LAM_RTOL,
                                                         atol=LAM_ATOL)
    else:
        p4 = _p4(blowup, n_pad, blowup["lam"])
        got = {s: cuda_pbf.project_pass_ref(cfg, p4, plan, N, split=s)
               for s in (True, False)}
        kept, cols, tol = slice(3, 4), slice(0, 3), dict(rtol=0,
                                                         atol=POS_ATOL)
    assert torch.equal(got[True][:N, kept], p4[:N, kept])
    split = got[True][:N, cols].numpy().squeeze(-1 if kind == "density"
                                                 else ())
    for want in (got[False][:N, cols].numpy().squeeze(
            -1 if kind == "density" else ()), tc_jax[kind, form]):
        np.testing.assert_allclose(split, want, **tol)
    if seg == WHOLE:  # one segment per chunk: the plain sum itself
        assert torch.equal(got[True], got[False])


@pytest.mark.parametrize("seg", SEGS)
def test_segment_sum_adds_partials_in_segment_order(seg):
    rng = np.random.default_rng(seg)
    terms = torch.from_numpy(rng.random((3, 5, 300)).astype(np.float32))
    got = cuda_pbf.segment_sum(terms, seg)
    parts = [terms[..., a:a + seg].double().sum(-1)
             for a in range(0, 300, seg)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    if seg >= 300:  # one segment: the row sum itself
        assert torch.equal(got, terms.sum(-1))


@pytest.mark.parametrize("seg", SEGS)
def test_stepper_scratch_is_allocated_once(seg, monkeypatch):
    """No step allocates a scratch: the Stepper allocates it once, on the
    card only, whose kernels write it (chip_smoke.py checks there that the
    rollout keeps the Stepper's scratch and leaves its counters at 0); the
    CPU's plain versions need none. A 3-step window rollout still matches
    the JAX dense oracle."""
    jcfg = jpbf.default_config(n=256)
    cfg = _cfg(seg, jcfg)
    n_pad = cuda_pbf.pad_to_chunks(cfg, 256)
    scratch = cuda_pbf.alloc_scratch(cfg, n_pad, "cpu")
    assert scratch.partials.shape == (cuda_pbf.ITEMS_PER_CHUNK * n_pad, 4)
    assert tuple(scratch.counters.shape) == (n_pad // cfg.geom.own + 2,)
    assert not scratch.counters.any()

    allocs = []
    alloc = cuda_pbf.alloc_scratch
    monkeypatch.setattr(cuda_pbf, "alloc_scratch",
                        lambda *a: allocs.append(a) or alloc(*a))
    st = jpbf.spawn(jcfg, "blowup", seed=1)
    state = interop.state_from_numpy(st.x, st.v, st.ids, st.step, "cpu")
    rollout = tstep.make_rollout(cfg, "window", 3, device="cpu")
    assert rollout.stepper.scratch is None
    state = rollout(state)
    assert rollout.stepper.scratch is None and allocs == []

    jstep = jmake_step(jcfg, backend="dense")
    for _ in range(3):
        st = jstep(st)
    inv = np.argsort(state.ids.numpy())
    np.testing.assert_allclose(state.x.numpy()[inv], np.asarray(st.x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seg", SEGS)
def test_checkpoint_keeps_the_segment_length(tmp_path, seg):
    """A checkpoint with the geometry's seg round-trips; a file whose
    geometry predates seg loads with its default."""
    cfg = default_config(n=128, geom=KernelGeometry(seg=seg))
    state = tstep.make_step(cfg, "window", device="cpu")(
        spawn(cfg, "standard", seed=0, device="cpu"))
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, state)
    cfg2, _ = checkpoint.load(path, device="cpu")
    assert cfg2 == cfg and cfg2.geom.seg == seg

    with np.load(path) as z:
        data = dict(z)
    data[checkpoint.GEOM_KEY] = np.bytes_(
        b'{"own": 64, "tile": 128, "mxu_sum": false, "mxu_rd2": false, '
        b'"mxu_proj": false}')
    np.savez(path, **data)
    cfg3, _ = checkpoint.load(path, device="cpu")
    assert cfg3.geom == KernelGeometry()
    assert cfg3.geom.seg == KernelGeometry.seg
