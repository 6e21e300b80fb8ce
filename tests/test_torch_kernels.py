"""The port's density and project passes against the JAX package's.

On the CPU the port's wrappers run their plain torch versions, which the
CUDA kernels are held against on the card (chip_smoke.py). Here they meet
the JAX Pallas kernels in interpret mode and the JAX dense oracle, on the
same cell-sorted n = 300 standard-scene positions (300 % 64 != 0, so the
last chunk mixes real and padding rows). Only the first n rows compare.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.ops import dense as jdense
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu.ops import pallas_pbf
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

torch.set_num_threads(1)

N = 300
LAM_TOL = dict(rtol=1e-5, atol=1e-7)
POS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    """Sorted positions, the port's plan, and the JAX outputs (built once:
    the interpret-mode passes dominate this file's time)."""
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
