"""The port's elementwise ops against the JAX package's, on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdb_sph_tpu import default_config
from pdb_sph_tpu.ops import collide as jcollide
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu.ops import integrate as jintegrate
from pdb_sph_tpu.ops import smoothing as jsmooth
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.ops import collide, hashgrid, integrate, smoothing

torch.set_num_threads(1)

JCFG = default_config(n=512)
TCFG = interop.config_from_fields(dataclasses.asdict(JCFG))
RTOL = 1e-6


def _close(t, j, scaled_atol=False):
    """rtol 1e-6. With scaled_atol, also an atol of 1e-6 of the array's
    largest magnitude: near r = h the (h - r) cancellation turns one ulp of
    difference between the two rsqrt implementations into a large relative
    error of a term that is tiny next to the others."""
    j = np.asarray(j)
    atol = RTOL * float(np.abs(j).max()) if scaled_atol else 0.0
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    rd2 = (rng.random(4096) * 2.0 * JCFG.h2).astype(np.float32)
    rd2[:8] = 0.0  # self pairs
    lam_i = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    lam_j = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    mask = rd2 < np.float32(JCFG.h2)
    return rd2, lam_i, lam_j, mask


def test_smoothing_matches_jax(pairs):
    rd2, lam_i, lam_j, mask = pairs
    t = {k: torch.from_numpy(a) for k, a in
         dict(rd2=rd2, li=lam_i, lj=lam_j, m=mask).items()}
    j = {k: jnp.asarray(a) for k, a in
         dict(rd2=rd2, li=lam_i, lj=lam_j, m=mask).items()}
    _close(smoothing.pair_distance(t["rd2"]), jsmooth.pair_distance(j["rd2"]),
           scaled_atol=True)
    _close(smoothing.poly6(TCFG, t["rd2"]), jsmooth.poly6(JCFG, j["rd2"]))
    for a, b in zip(smoothing.density_terms(TCFG, t["rd2"], t["m"]),
                    jsmooth.density_terms(JCFG, j["rd2"], j["m"])):
        _close(a, b, scaled_atol=True)
    _close(smoothing.lambda_from_sums(TCFG, t["rd2"] * 1e6, t["li"] * 1e6),
           jsmooth.lambda_from_sums(JCFG, j["rd2"] * 1e6, j["li"] * 1e6))
    _close(smoothing.delta_p_scale(TCFG, t["rd2"], t["li"], t["lj"], t["m"]),
           jsmooth.delta_p_scale(JCFG, j["rd2"], j["li"], j["lj"], j["m"]),
           scaled_atol=True)


def test_predict_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.random((512, 3)) * 2.0).astype(np.float32)
    v = rng.standard_normal((512, 3)).astype(np.float32)
    tp, tv = integrate.predict(TCFG, torch.from_numpy(x), torch.from_numpy(v))
    jp, jv = jintegrate.predict(JCFG, jnp.asarray(x), jnp.asarray(v))
    _close(tp, jp)
    _close(tv, jv)


@pytest.mark.parametrize("strict", [False, True])
def test_finalize_matches_jax_past_every_wall(strict):
    """Particles past each of the six walls, moving out of and into the
    box, through the ordered wall responses."""
    jcfg = dataclasses.replace(JCFG, strict_reference_collide=strict)
    tcfg = dataclasses.replace(TCFG, strict_reference_collide=strict)
    rng = np.random.default_rng(2)
    n = 1024
    last = (rng.random((n, 3)) * 2.0).astype(np.float32)
    p = (rng.random((n, 3)) * 3.0 - 0.5).astype(np.float32)
    for k, (axis, upper) in enumerate(jcollide._WALL_ORDER):
        rows = slice(k * 64, (k + 1) * 64)
        p[rows, axis] = 2.2 if upper else -0.2
        last[rows, axis] = np.where(np.arange(64) % 2, 1.0,
                                    2.4 if upper else -0.4)
    last[-4:] = p[-4:]  # v == 0 rows
    tx, tv = collide.finalize(tcfg, torch.from_numpy(p),
                              torch.from_numpy(last))
    jx, jv = jcollide.finalize(jcfg, jnp.asarray(p), jnp.asarray(last))
    _close(tx, jx)
    _close(tv, jv)
    if not strict:
        assert ((tx >= 0) & (tx <= tcfg.wall)).all()


def test_cell_ids_match_jax_exactly():
    rng = np.random.default_rng(3)
    p = (rng.random((4096, 3)) * 4.0 - 1.0).astype(np.float32)
    p[:16] = np.float32(TCFG.nb_cell) * np.arange(16)[:, None]  # cell edges
    got = hashgrid.cell_ids(TCFG, torch.from_numpy(p))
    want = np.asarray(jhash.cell_ids(JCFG, jnp.asarray(p)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_by_cell_is_stable():
    cid = torch.tensor([3, 1, 3, 0, 1, 3], dtype=torch.int32)
    s, order = hashgrid.sort_by_cell(TCFG, cid)
    assert s.tolist() == [0, 1, 1, 3, 3, 3]
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
