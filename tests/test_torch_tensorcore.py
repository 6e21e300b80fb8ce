"""The port's tensor-core forms of the passes against the JAX kernels'.

The geometry's `mxu_rd2`, `mxu_sum` and `mxu_proj` switches select other
functions than the FP32 passes: rd2 as (|o|^2 - (dot + dot)) + |c|^2 with
the dot of a bf16 hi/lo split, and delta-p as own3 * S - acc_p with s split
too. On the CPU the port's wrappers run the plain versions of those forms
(the tensor-core kernels of csrc/pbf_tc.cu are held against them on the
card, chip_smoke.py); here they meet the JAX Pallas kernels in interpret
mode with the same switches, on the n = 300 standard input of
test_torch_kernels.py. Only the first n rows compare.

Tolerances. On this input JAX's own tensor-core forms move lambda by up to
3.07e-7 and the projected positions by up to 5.39e-6 from its FP32 forms.
- lambda: LAM_ATOL, a tenth of that difference;
- positions of the `{sum}` project form: POS_ATOL, a tenth;
- positions of the `{proj}` forms: PROJ_ATOL. A tenth cannot hold there,
  for a reason of the form itself: its self pair keeps a term
  k * s_ii * (p_i - split(p_i)) of ~5e-7 that jumps with the last bit of
  the self pair's rd2, and JAX's compiled interpret pass rounds |p|^2 and
  the dot with FMA contractions that op-by-op evaluation does not. Measured
  on this input, JAX's pass lies up to 1.17e-6 from a float64 evaluation
  of the same form on the same rounded s, the port's plain pass 3.7e-8
  from it: PROJ_ATOL is that floor with a margin, and a quarter of the
  forms' difference. The port's pass is also held to that float64
  evaluation at POS_ATOL, a tenth of the forms' difference;
- the 3-iteration solve: SOLVE_ATOL, the same floor compounded over three
  iterations (measured 3.93e-6 against a form difference of 9.83e-6).
  No reference that rounds otherwise can hold the solve much tighter: a
  last-bit change of a position moves its bf16 split and its self pair's
  rd2, so the port's own solve and the same solve with the proj form's
  sums in float64 already lie 7.7e-7 apart after three iterations, where
  one pass lies 3.5e-8 apart.
Every test that compares a `rd2` or `proj` form also asserts that the FP32
form falls outside its tolerance (by 10x for lambda, 3x for one project
pass), so that the test tells the two forms apart; the `sum` forms are the
FP32 function, and their plain versions are the FP32 passes bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu.ops import pallas_pbf
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

torch.set_num_threads(1)

N = 300
SOLVE_ITERS = 3
LAM_ATOL = 3.0e-8    # a tenth of JAX's lambda form difference, 3.07e-7
POS_ATOL = 5.0e-7    # a tenth of JAX's position form difference, 5.39e-6
PROJ_ATOL = 1.5e-6   # JAX's f32 floor of the proj form (see above)
SOLVE_ATOL = 5.0e-6  # that floor over three iterations

# The JAX density pass does not read mxu_proj, nor the project pass mxu_rd2:
# the two-switch forms run with every switch on, so that the solve reuses
# their compiled kernels.
ALL = dict(mxu_rd2=True, mxu_sum=True, mxu_proj=True)
DENSITY_FORMS = {"rd2": dict(mxu_rd2=True), "sum": dict(mxu_sum=True),
                 "rd2_sum": ALL}
PROJECT_FORMS = {"proj": dict(mxu_proj=True), "sum": dict(mxu_sum=True),
                 "proj_sum": ALL}


def _jcfg(**switches):
    # gb=2 cuts the Pallas grid to n_pad = 384, as in test_torch_kernels.py
    return jpbf.default_config(n=N, geom=dataclasses.replace(
        jpbf.KernelGeometry(), gb=2, **switches))


@pytest.fixture(scope="module")
def case():
    """Sorted positions, the port's plan, and every JAX pass this file
    compares with, built once: each set of switches compiles its own
    interpret-mode kernel. The FP32 forms that the tests tell apart are the
    port's plain FP32 passes, which test_torch_kernels.py holds against
    JAX's."""
    jcfg = _jcfg()
    x = jpbf.spawn(jcfg, "standard", seed=2).x
    n_pad_j = pallas_pbf.pad_to_chunks(jcfg, N)
    cid = jhash.cell_ids(jcfg, x)
    cid_pad = jnp.concatenate(
        [cid, jnp.full((n_pad_j - N,), jcfg.num_nb_cells, jnp.int32)])
    sc, order = jhash.sort_by_cell(jcfg, cid_pad)
    ps = np.asarray(x)[np.asarray(order[:N])]
    plan_j = pallas_pbf.build_plan(jcfg, sc)
    pT0 = pallas_pbf.make_pT(jcfg, jnp.asarray(ps), n_pad_j)

    def jdensity(switches, pT):
        c = _jcfg(**switches)
        return pallas_pbf.density_pass(c, pT, pallas_pbf._p4_from_pT(c, pT),
                                       plan_j, interpret=True)

    def jproject(switches, pT, lam):
        c = _jcfg(**switches)
        pT = pT.at[:, 3].set(lam[:, 0])
        p4 = pallas_pbf.splice_lambda(c, pallas_pbf._p4_from_pT(c, pT), lam,
                                      n_pad_j)
        return pallas_pbf.project_pass(c, pT, p4, plan_j, interpret=True)

    lam = {name: jdensity(sw, pT0) for name, sw in DENSITY_FORMS.items()}
    # every project form takes the all-switches density's lambda, so the
    # `proj_sum` pass is also the first iteration of the solve
    proj = {name: jproject(sw, pT0, lam["rd2_sum"])
            for name, sw in PROJECT_FORMS.items()}
    pT = proj["proj_sum"]
    for _ in range(SOLVE_ITERS - 1):
        pT = jproject(ALL, pT, jdensity(ALL, pT))

    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    n_pad = cuda_pbf.pad_to_chunks(cfg, N)
    tcid = hashgrid.cell_ids(cfg, torch.from_numpy(ps))
    plan = cuda_pbf.build_plan(
        cfg, torch.cat([tcid, tcid.new_full((n_pad - N,),
                                            cfg.num_nb_cells)]))
    return dict(cfg=cfg, ps=ps, plan=plan, n_pad=n_pad,
                lam={k: np.asarray(v)[:N, 0] for k, v in lam.items()},
                proj={k: np.asarray(v)[:N, :3] for k, v in proj.items()},
                solved=np.asarray(pT)[:N, :3])


def _cfg(case, **switches):
    cfg = case["cfg"]
    return dataclasses.replace(
        cfg, geom=dataclasses.replace(cfg.geom, **switches))


def _p4(case, lam=None):
    p4 = torch.zeros((case["n_pad"], 4), dtype=torch.float32)
    p4[:N, :3] = torch.tensor(case["ps"])
    if lam is not None:
        p4[:N, 3] = torch.tensor(lam)
    return p4


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("form", sorted(DENSITY_FORMS))
def test_density_form_matches_jax(case, form):
    switches = DENSITY_FORMS[form]
    p4 = _p4(case)
    out = cuda_pbf.density_pass(_cfg(case, **switches), p4, case["plan"], N)
    lam, want = out[:N, 3].numpy(), case["lam"][form]
    np.testing.assert_allclose(lam, want, rtol=0, atol=LAM_ATOL)
    assert torch.equal(out[:N, :3], p4[:N, :3])
    assert not out[N:].any()
    fp32 = cuda_pbf.density_pass(case["cfg"], p4, case["plan"], N)[:N, 3]
    if switches.get("mxu_rd2"):
        # the forms differ by 10x the tolerance
        assert _maxdiff(want, fp32) >= 10 * LAM_ATOL
    else:
        # the row sums' tensor-core form is the FP32 function: its plain
        # version is the FP32 pass, bit for bit
        assert torch.equal(out[:N, 3], fp32)


@pytest.mark.parametrize("form", sorted(PROJECT_FORMS))
def test_project_form_matches_jax(case, form):
    switches = PROJECT_FORMS[form]
    p4 = _p4(case, case["lam"]["rd2_sum"])
    out = cuda_pbf.project_pass(_cfg(case, **switches), p4, case["plan"], N)
    pos, want = out[:N, :3].numpy(), case["proj"][form]
    fp32 = cuda_pbf.project_pass(case["cfg"], p4, case["plan"], N)[:N, :3]
    assert torch.equal(out[:N, 3], p4[:N, 3])
    if switches.get("mxu_proj"):
        np.testing.assert_allclose(pos, want, rtol=0, atol=PROJ_ATOL)
        assert _maxdiff(want, fp32) >= 3 * PROJ_ATOL
    else:
        np.testing.assert_allclose(pos, want, rtol=0, atol=POS_ATOL)
        assert torch.equal(out[:N, :3], fp32)


def _proj_form_f64(cfg, p4, plan) -> np.ndarray:
    """The `proj` form's positions from the pass's own float32 rd2 and s,
    with the split contraction and the epilogue in float64: the form
    without the rounding of its sums."""
    h, s_corr = cuda_pbf.f32(cfg.h), cuda_pbf.f32(cfg.s_corr)
    k = float(cuda_pbf.f32(-cfg.spiky_grad_coeff * cfg.inv_rho0))
    out = np.zeros((N, 3))
    for row0, mine, _, rd2, mask, cand in cuda_pbf._pair_blocks(
            cfg, p4, plan, N, split_rd2=True):
        u = h - rd2 * torch.rsqrt(rd2)
        s = (u * u) * ((mine[..., 3] + s_corr)[:, :, None]
                       + cand[:, None, :, 3])
        s = torch.where(mask, s, torch.zeros_like(s))
        sh, sl = (t.double() for t in cuda_pbf.bf16_split(s))
        ch, cl = (t.double() for t in cuda_pbf.bf16_split(cand[..., :3]))
        acc_p = (torch.einsum("bol,blc->boc", sh, ch + cl)
                 + torch.einsum("bol,blc->boc", sl, ch))
        own3 = mine[..., :3].double()
        moved = own3 + k * (own3 * s.double().sum(-1)[..., None] - acc_p)
        rows = moved.reshape(-1, 3)[:max(0, N - row0)]
        out[row0:row0 + rows.shape[0]] = rows.numpy()
    return out


@pytest.mark.parametrize("form", ["proj", "proj_sum"])
def test_project_form_matches_its_float64_evaluation(case, form):
    cfg = _cfg(case, **PROJECT_FORMS[form])
    p4 = _p4(case, case["lam"]["rd2_sum"])
    got = cuda_pbf.project_pass(cfg, p4, case["plan"], N)[:N, :3].numpy()
    want = _proj_form_f64(cfg, p4, case["plan"])
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_ATOL)
    fp32 = cuda_pbf.project_pass(case["cfg"], p4, case["plan"], N)
    assert _maxdiff(want, fp32[:N, :3]) >= 10 * POS_ATOL


def test_bf16_split_is_jax_bitwise():
    rng = np.random.default_rng(11)
    a = np.concatenate([
        rng.uniform(-2.5, 2.5, 4096),
        rng.uniform(-1e-3, 1e-3, 1024),
        rng.normal(0.0, 1e4, 1024),
        [0.0, -0.0, 1.0, 2.0, 1e-30, 3.3895314e38],
    ]).astype(np.float32)
    hi, lo = cuda_pbf.bf16_split(torch.from_numpy(a))
    jhi, jlo = pallas_pbf._bf16_split(jnp.asarray(a))
    for got, want in ((hi, jhi), (lo, jlo)):
        assert got.dtype == torch.bfloat16
        got = got.view(torch.int16).numpy()
        want = np.asarray(want).view(np.int16)
        np.testing.assert_array_equal(got, want)


def test_solve_with_every_switch_matches_jax(case):
    ps = torch.from_numpy(case["ps"])
    got = cuda_pbf.solve(_cfg(case, **ALL), ps, case["plan"]).numpy()
    fp32 = cuda_pbf.solve(case["cfg"], ps, case["plan"]).numpy()
    want = case["solved"]
    np.testing.assert_allclose(got, want, rtol=0, atol=SOLVE_ATOL)
    assert _maxdiff(fp32, want) > SOLVE_ATOL


def test_bf16_split_of_float64_is_the_float32_split():
    """A float64 tensor of float32 values splits as the float32 one does,
    so the plain versions' float64 evaluation keeps the form's bf16
    pieces."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(np.concatenate([
        rng.uniform(-4.64, 4.64, 4096), rng.uniform(-1e-3, 1e-3, 1024),
        [0.0, -0.0, 1.0, 2.0, 1e-30]]).astype(np.float32))
    for got, want in zip(cuda_pbf.bf16_split(a.double()),
                         cuda_pbf.bf16_split(a)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("form", ["proj", "proj_sum"])
def test_project_form_in_float64_is_the_form_unrounded(case, form):
    """The plain version on float64 input is the same form with its sums
    in float64 (the witness chip_smoke.py holds the proj kernels' rounding
    to): the float32 plain version lies within PROJ_ATOL of it (the floor
    of the form's float32 rounding, measured 1.03e-6 here), and it lies 3x
    that from the FP32 form."""
    cfg = _cfg(case, **PROJECT_FORMS[form])
    p4 = _p4(case, case["lam"]["rd2_sum"])
    f64 = cuda_pbf.project_pass_ref(cfg, p4.double(), case["plan"], N)
    f32 = cuda_pbf.project_pass_ref(cfg, p4, case["plan"], N)
    assert f64.dtype == torch.float64
    assert torch.equal(f64[:N, 3], p4[:N, 3].double())
    np.testing.assert_allclose(f32[:N, :3].numpy(), f64[:N, :3].numpy(),
                               rtol=0, atol=PROJ_ATOL)
    fp32 = cuda_pbf.project_pass(case["cfg"], p4, case["plan"], N)
    assert _maxdiff(f64[:N, :3].numpy(), fp32[:N, :3].numpy()) \
        >= 3 * PROJ_ATOL
