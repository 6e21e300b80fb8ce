"""The port's step and rollout (the slice as a whole) against the JAX
package, on the CPU, from the very same particles (JAX spawn -> numpy)."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import make_step as jmake_step
from pdb_sph_tpu_torch import default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


def _pair(jcfg, scene, seed):
    st = jpbf.spawn(jcfg, scene, seed=seed)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    return cfg, st, interop.state_from_numpy(st.x, st.v, st.ids, st.step,
                                             "cpu")


def _unsort(x, v, ids):
    inv = np.argsort(np.asarray(ids))
    return np.asarray(x)[inv], np.asarray(v)[inv]


def test_window_three_steps_match_jax_dense():
    jcfg = jpbf.default_config(n=256)
    cfg, a, b = _pair(jcfg, "standard", 1)
    jstep = jmake_step(jcfg, backend="dense")
    stepper = tstep.make_step(cfg, "window", device="cpu")
    for _ in range(3):
        a, b = jstep(a), stepper(b)
    x, _, ids, step = interop.state_to_numpy(b)
    assert int(step) == 3
    x_u, _ = _unsort(x, x, ids)
    np.testing.assert_allclose(x_u, np.asarray(a.x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scene", ["standard", "blowup"])
def test_window_step_matches_jax_cell(scene):
    jcfg = jpbf.default_config(n=512, max_occupied_cells=1024,
                               cell_capacity=256)
    cfg, a, b = _pair(jcfg, scene, 0)
    a = jmake_step(jcfg, backend="cell")(a)
    b = tstep.make_step(cfg, "window", device="cpu")(b)
    xa, va = _unsort(a.x, a.v, a.ids)
    xb, vb = _unsort(b.x.numpy(), b.v.numpy(), b.ids.numpy())
    np.testing.assert_allclose(xb, xa, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vb, va, rtol=1e-4, atol=1e-4)


def test_dense_backend_matches_jax_dense():
    jcfg = jpbf.default_config(n=256)
    cfg, a, b = _pair(jcfg, "blowup", 2)
    a = jmake_step(jcfg, backend="dense")(a)
    b = tstep.make_step(cfg, "dense", device="cpu")(b)
    np.testing.assert_allclose(b.x.numpy(), np.asarray(a.x), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(b.ids, torch.arange(256, dtype=torch.int32))


def test_rollout_with_stats_keeps_a_finite_boxed_state():
    cfg = default_config(n=1024)
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    state, stats = tstep.make_rollout(cfg, "window", 10, with_stats=True,
                                      device="cpu")(st)
    assert stats.dtype == torch.int32 and stats.tolist() == [0, 0, 0]
    assert int(state.step) == 10
    assert torch.isfinite(state.x).all() and torch.isfinite(state.v).all()
    assert ((state.x >= 0) & (state.x <= cfg.wall)).all()
    assert sorted(state.ids.tolist()) == list(range(1024))


def test_rollout_counts_nonfinite_steps():
    cfg = default_config(n=256)
    st = spawn(cfg, "standard", seed=0, device="cpu")
    st = st._replace(x=st.x.clone())
    st.x[5, 1] = float("nan")
    _, stats = tstep.make_rollout(cfg, "window", 2, with_stats=True,
                                  device="cpu")(st)
    assert stats.tolist() == [0, 0, 2]


def test_backend_and_state_checks():
    cfg = default_config(n=256)
    assert tstep.resolve_backend("auto") == "window"
    with pytest.raises(ValueError):
        tstep.make_step(cfg, "pallas")
    with pytest.raises(ValueError):
        tstep.make_rollout(cfg, "window", 0)
    wrong_n = spawn(dataclasses.replace(cfg, n=128), "standard", 0,
                    device="cpu")
    with pytest.raises(ValueError):
        tstep.make_step(cfg, "window", device="cpu")(wrong_n)


def test_cuda_request_without_cuda_or_nvcc_raises(monkeypatch):
    """No fallback: a CUDA request without a card, or a kernel build
    without nvcc, raises instead of running plain torch."""
    cfg = default_config(n=256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tstep.make_step(cfg, "window", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tstep.make_rollout(cfg, "auto", 4, device="cuda:0")

    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR",
                        cuda_build.BUILD_DIR / "absent-for-test")
    cuda_build.load_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.load_kernels()
    finally:
        cuda_build.load_kernels.cache_clear()
