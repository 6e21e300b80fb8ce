"""Checkpoints across the two packages, and the port's frames and renderer
against the JAX package's, on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import make_step as jmake_step
from pdb_sph_tpu.geometry import KernelGeometry as JGeometry
from pdb_sph_tpu.io import checkpoint as jcheckpoint
from pdb_sph_tpu.io import frames as jframes
from pdb_sph_tpu.render import renderer as jrenderer
from pdb_sph_tpu_torch import KernelGeometry, default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.io import checkpoint, frames
from pdb_sph_tpu_torch.render import renderer

torch.set_num_threads(1)


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "geom"}


def _assert_same_arrays(got, want):
    """Four (x, v, ids, step) arrays equal bit for bit, dtypes included."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_jax_checkpoint_loads_in_the_port_and_steps_alike(tmp_path):
    # a cell table that keeps every particle, small enough to compile fast
    jcfg = jpbf.default_config(n=512, max_occupied_cells=512,
                               cell_capacity=32, block=32)
    jstep = jmake_step(jcfg, backend="cell")
    st = jstep(jpbf.spawn(jcfg, "dam_break", seed=5))
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jcfg, st)

    cfg, state = checkpoint.load(path)
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.geom == KernelGeometry()  # the TPU geometry is dropped
    _assert_same_arrays(interop.state_to_numpy(state), st)
    assert state.step.dtype == torch.int32 and int(state.step) == 1

    stepper = tstep.make_step(cfg, "window")
    for _ in range(3):
        st, state = jstep(st), stepper(state)
    x, v, ids, step = interop.state_to_numpy(state)
    assert int(step) == int(st.step) == 4
    mine, theirs = np.argsort(ids), np.argsort(np.asarray(st.ids))
    np.testing.assert_allclose(x[mine], np.asarray(st.x)[theirs],
                               rtol=1e-4, atol=1e-5)
    # v = (x - x_last) / dt carries the position tolerance times 1/dt ~ 116
    np.testing.assert_allclose(v[mine], np.asarray(st.v)[theirs],
                               rtol=1e-4, atol=1e-3)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    cfg = default_config(n=256, wall=2.5, s_corr=2e-4)
    state = tstep.make_step(cfg, "window")(spawn(cfg, "standard", seed=2))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, cfg, state)

    jcfg, st = jcheckpoint.load(path)
    assert _fields(jcfg) == _fields(cfg)
    assert jcfg.geom == JGeometry()  # no geom key: the JAX default
    _assert_same_arrays(st, interop.state_to_numpy(state))


def test_port_roundtrip_keeps_its_geometry(tmp_path):
    geom = KernelGeometry(own=128, tile=64)
    cfg = default_config(n=300, geom=geom)
    state = spawn(cfg, "blowup", seed=1)
    path = str(tmp_path / "sub" / "ck.npz")
    checkpoint.save(path, cfg, state)
    cfg2, state2 = checkpoint.load(path, device="cpu")
    assert cfg2 == cfg and cfg2.geom == geom
    _assert_same_arrays(interop.state_to_numpy(state2),
                        interop.state_to_numpy(state))
    assert os.listdir(tmp_path / "sub") == ["ck.npz"]


def test_port_roundtrip_keeps_the_tensor_core_switches(tmp_path):
    geom = KernelGeometry(mxu_rd2=True, mxu_proj=True, mxu_sum=True)
    cfg = default_config(n=256, geom=geom)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, spawn(cfg, "dam_break", seed=0))
    cfg2, _ = checkpoint.load(path)
    assert cfg2 == cfg and cfg2.geom == geom


def test_geometry_without_switches_loads_with_them_off(tmp_path,
                                                        monkeypatch):
    """A port file whose geometry predates the switches: (own, tile) only."""
    monkeypatch.setenv("PBF_MXU_RD2", "1")  # the file's geometry wins
    cfg = default_config(n=64, geom=KernelGeometry(own=128, tile=64))
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, spawn(cfg, "standard", seed=0))
    with np.load(path) as z:
        data = dict(z)
    data[checkpoint.GEOM_KEY] = np.bytes_(b'{"own": 128, "tile": 64}')
    np.savez(path, **data)
    cfg2, _ = checkpoint.load(path)
    assert cfg2.geom == KernelGeometry(own=128, tile=64)
    assert not (cfg2.geom.mxu_rd2 or cfg2.geom.mxu_sum or cfg2.geom.mxu_proj)


def test_jax_checkpoint_with_switches_resumes_on_them(tmp_path):
    jgeom = dataclasses.replace(JGeometry(), mxu_rd2=True, mxu_proj=True,
                                mxu_sum=True)
    jcfg = jpbf.default_config(n=256, geom=jgeom)
    st = jpbf.spawn(jcfg, "dam_break", seed=3)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jcfg, st)
    cfg, state = checkpoint.load(path)
    assert cfg.geom == KernelGeometry(mxu_rd2=True, mxu_proj=True,
                                      mxu_sum=True)
    _assert_same_arrays(interop.state_to_numpy(state), st)
    # and the port's resumed step runs the tensor-core forms' plain versions
    fp32 = dataclasses.replace(cfg, geom=KernelGeometry())
    x_tc = tstep.make_step(cfg, "window")(state).x
    x_fp = tstep.make_step(fp32, "window")(state).x
    assert torch.isfinite(x_tc).all() and not torch.equal(x_tc, x_fp)


def test_checkpoint_refuses_a_wrong_version_or_shape(tmp_path):
    cfg = default_config(n=64)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, spawn(cfg, "standard", seed=0))
    with np.load(path) as z:
        data = dict(z)
    np.savez(path, **{**data, "format_version": np.int32(2)})
    with pytest.raises(ValueError, match="version"):
        checkpoint.load(path)
    np.savez(path, **{**data, "x": data["x"][:32]})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path)


def test_failed_save_leaves_no_temp_file(tmp_path, monkeypatch):
    cfg = default_config(n=64)
    state = spawn(cfg, "standard", seed=0)
    path = tmp_path / "ck.npz"
    checkpoint.save(str(path), cfg, state)
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        checkpoint.save(str(path), cfg, state)
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert path.read_bytes() == before


def _frames(k=3, h=24, w=32, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        f = np.full((h, w, 3), (12, 12, 20), np.uint8)
        ys, xs = rng.integers(0, h, 9), rng.integers(0, w, 9)
        f[ys, xs] = rng.integers(0, 256, (9, 3))
        out.append(f)
    return out


@pytest.mark.parametrize("fmt", ["png", "gif", "gif_palette"])
def test_encoders_write_the_jax_bytes(tmp_path, fmt):
    frs = _frames()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    if fmt == "png":
        frames.write_png(a, frs[0])
        jframes.write_png(b, frs[0])
        np.testing.assert_array_equal(frames.read_png(a), frs[0])
    else:
        kw = dict(fps=20)
        if fmt == "gif_palette":
            kw["palette_rgb"] = np.concatenate([f.reshape(-1, 3)
                                                for f in frs])
        frames.write_gif(a, frs, **kw)
        jframes.write_gif(b, iter(frs), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_renderer_draws_the_jax_image(path):
    pos = np.random.default_rng(0).uniform(0.2, 1.8, (300, 3)).astype(
        np.float32)
    if path == "native":
        assert renderer.have_native() and jrenderer.have_native()
        got = renderer.render(pos, 96, 64, eye=(3.0, 2.0, -1.0))
        want = jrenderer.render(pos, 96, 64, eye=(3.0, 2.0, -1.0))
    else:
        args = (pos, 96, 64, renderer.DEFAULT_EYE, renderer.DEFAULT_TARGET,
                renderer.DEFAULT_FOV, renderer.POINT_SCALE, renderer.COLOR,
                renderer.BACKGROUND)
        got, want = renderer._render_numpy(*args), jrenderer._render_numpy(
            *args)
    assert got.shape == (64, 96, 3) and got.max() > 30
    np.testing.assert_array_equal(got, want)


def test_native_renderer_builds_outside_the_jax_tree():
    assert renderer.have_native()
    lib = renderer._build_lib()
    assert lib.parent == renderer.BUILD_DIR and lib.exists()
    assert renderer.SOURCE.exists()


def test_frame_writer_takes_a_tensor_copy_at_submit(tmp_path):
    pos = torch.from_numpy(
        np.random.default_rng(3).uniform(0.5, 1.5, (80, 3)).astype(
            np.float32))
    want = renderer.render(pos.numpy().copy(), 64, 48)
    out = str(tmp_path / "fr")
    with frames.FrameWriter(out, width=64, height=48) as w:
        w.submit(7, pos)
        pos.fill_(float("nan"))  # the writer holds its own host copy
    assert w.frames_written == 1
    np.testing.assert_array_equal(
        frames.read_png(os.path.join(out, "frame_000007.png")), want)
