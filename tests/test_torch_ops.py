"""The port's elementwise ops against the JAX package's, on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu import default_config
from pdb_sph_tpu.core import step as jstep
from pdb_sph_tpu.ops import collide as jcollide
from pdb_sph_tpu.ops import hashgrid as jhash
from pdb_sph_tpu.ops import integrate as jintegrate
from pdb_sph_tpu.ops import smoothing as jsmooth
from pdb_sph_tpu_torch import interop
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.ops import (collide, cuda_pbf, hashgrid, integrate,
                                   smoothing)

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


def _past_every_wall(n: int = 1024):
    """(p, last): rows past each of the six walls, moving out of and into
    the box, and v == 0 rows."""
    rng = np.random.default_rng(2)
    last = (rng.random((n, 3)) * 2.0).astype(np.float32)
    p = (rng.random((n, 3)) * 3.0 - 0.5).astype(np.float32)
    for k, (axis, upper) in enumerate(jcollide._WALL_ORDER):
        rows = slice(k * 64, (k + 1) * 64)
        p[rows, axis] = 2.2 if upper else -0.2
        last[rows, axis] = np.where(np.arange(64) % 2, 1.0,
                                    2.4 if upper else -0.4)
    last[-4:] = p[-4:]  # v == 0 rows
    return p, last


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("strict", [False, True])
def test_finalize_matches_jax_past_every_wall(strict):
    """Particles past each of the six walls, moving out of and into the
    box, through the ordered wall responses."""
    jcfg = dataclasses.replace(JCFG, strict_reference_collide=strict)
    tcfg = dataclasses.replace(TCFG, strict_reference_collide=strict)
    p, last = _past_every_wall()
    tx, tv = collide.finalize(tcfg, torch.from_numpy(p),
                              torch.from_numpy(last))
    jx, jv = jcollide.finalize(jcfg, jnp.asarray(p), jnp.asarray(last))
    _close(tx, jx)
    _close(tv, jv)
    if not strict:
        assert ((tx >= 0) & (tx <= tcfg.wall)).all()


@pytest.mark.parametrize("layout", ["rows", "solve_buffer"])
@pytest.mark.parametrize("nonfinite_rows", [False, True],
                         ids=["finite", "nan_inf"])
@pytest.mark.parametrize("strict", [False, True])
def test_finalize_on_the_cpu_is_the_plain_chain(strict, nonfinite_rows,
                                                layout):
    """A CPU tensor takes the plain chain, bit for bit, launches nothing
    and carries no kernel flag, and matches JAX; `p` as contiguous rows or
    as the (n, 3) view of the solve's (n_pad, 4) buffer; NaN and inf in
    p, in last, and a NaN velocity at a wall."""
    jcfg = dataclasses.replace(JCFG, strict_reference_collide=strict)
    tcfg = dataclasses.replace(TCFG, strict_reference_collide=strict)
    p, last = _past_every_wall()
    if nonfinite_rows:
        p[400, 1], p[401, 0], p[402, 2] = np.nan, np.inf, -np.inf
        last[403, 0], last[404, 2] = np.nan, -np.inf
        p[405, 0], last[405, 0] = -0.2, np.nan  # NaN velocity at x = 0
    tp = torch.from_numpy(p)
    if layout == "solve_buffer":
        buf = torch.zeros((p.shape[0] + 64, 4), dtype=torch.float32)
        buf[:p.shape[0], :3] = tp
        tp = buf[:p.shape[0], :3]
    before = dict(cuda_pbf.LAUNCHES)
    got = collide.finalize(tcfg, tp, torch.from_numpy(last))
    assert cuda_pbf.LAUNCHES == before
    assert not isinstance(got, collide.Finalized)
    want = collide.finalize_ref(tcfg, torch.from_numpy(p),
                                torch.from_numpy(last))
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    jx, jv = jcollide.finalize(jcfg, jnp.asarray(p), jnp.asarray(last))
    _close(got[0], jx)
    _close(got[1], jv)
    if nonfinite_rows:
        # bounced into NaN in the strict mode, clamped into the box else
        assert bool(torch.isnan(got[0][405]).all()) == strict


@pytest.mark.parametrize("case", ["rows", "solve_buffer", "wide_rows",
                                  "columns_apart", "float64", "short"])
def test_the_kernel_wrapper_takes_rows_of_any_stride(case):
    """`_rows` gives the row stride of (n, 3) float32 rows with adjacent
    columns, which the kernel reads without a copy, and refuses the
    rest."""
    n = 8
    buf = torch.zeros((n, 6), dtype=torch.float32)
    t = {"rows": buf[:, :3].contiguous(), "solve_buffer": buf[:, :4][:, :3],
         "wide_rows": buf[:, 1:4], "columns_apart": buf[:, ::2],
         "float64": buf[:, :3].double(), "short": buf[:n - 1, :3]}[case]
    if case in ("rows", "solve_buffer", "wide_rows"):
        assert collide._rows("p", t, n, t.device) == t.stride(0)
    else:
        with pytest.raises(ValueError, match="adjacent columns"):
            collide._rows("p", t, n, t.device)


NONFINITE_CASES = {
    # (strict_reference_collide, the state's coordinate made non-finite)
    "all_finite": (False, None),
    "nan_in_x": (False, ("x", 7, 1, np.nan)),
    "inf_in_v": (False, ("v", 7, 0, np.inf)),
    # -inf - -inf: a NaN velocity on a particle past the wall x = 0, which
    # the strict mode bounces
    "strict_nan_velocity_at_a_wall": (True, ("x", 7, 0, -np.inf)),
}


@pytest.mark.parametrize("case", sorted(NONFINITE_CASES))
def test_the_step_nonfinite_stat_keeps_its_meaning(case):
    """step_fn's stats[2] on the CPU is the JAX step's stats[2] from the
    same planted state, and 1 exactly when the step's x or v holds a
    non-finite value. (On a card the kernel's flag is held to this plain
    check by chip_smoke.py's finalize phase.)"""
    strict, plant = NONFINITE_CASES[case]
    jcfg = dataclasses.replace(JCFG, strict_reference_collide=strict)
    tcfg = dataclasses.replace(TCFG, strict_reference_collide=strict)
    js = jpbf.spawn(jcfg, "dam_break", seed=0)
    arrays = {"x": np.array(js.x), "v": np.array(js.v)}
    if plant is not None:
        name, row, axis, value = plant
        arrays[name][row, axis] = value
    js = js._replace(x=jnp.asarray(arrays["x"]), v=jnp.asarray(arrays["v"]))
    state = interop.state_from_numpy(arrays["x"], arrays["v"], js.ids,
                                     js.step, "cpu")
    out, stats = tstep.step_fn(tcfg, "window", state, with_stats=True)
    _, jstats = jstep.step_fn(jcfg, "cell", js, with_stats=True)
    finite = bool(torch.isfinite(out.x).all() & torch.isfinite(out.v).all())
    assert finite == (plant is None)
    assert stats.dtype == torch.int32
    assert stats.tolist() == [0, 0, int(not finite)]
    assert int(stats[2]) == int(np.asarray(jstats)[2])


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
