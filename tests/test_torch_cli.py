"""The port's runner (`python -m pdb_sph_tpu_torch.cli`) against the JAX
runner, on the CPU (`--device cpu`, n = 256); its cell backend and its
sharded path (`--devices 1` in-process, `--fake-devices 2`: two gloo
ranks, one process each)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu import cli as jcli
from pdb_sph_tpu.geometry import KernelGeometry as JKernelGeometry
from pdb_sph_tpu.io import checkpoint as jcheckpoint
from pdb_sph_tpu_torch import cli, default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.io import checkpoint
from pdb_sph_tpu_torch.parallel import sharded

torch.set_num_threads(1)

RUN = ["--scene", "dam_break", "--n", "256", "--steps", "4", "--chunk", "2",
       "--metrics-every", "2", "--render-every", "2", "--width", "64",
       "--height", "48"]
RESUME = ["--steps", "2", "--chunk", "2"]


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run(main, tmp, backend, extra=()):
    """A run with metrics, frames, a GIF and a checkpoint, then a resume of
    it that writes the checkpoint again; returns (run records, resume
    records, checkpoint path)."""
    os.makedirs(tmp, exist_ok=True)
    ck, m1, m2 = (os.path.join(tmp, f) for f in ("ck.npz", "m1", "m2"))
    rc = main(RUN + ["--backend", backend, "--metrics", m1, "--checkpoint",
                     ck, "--out", os.path.join(tmp, "fr"), "--gif",
                     os.path.join(tmp, "a.gif"), *extra])
    assert rc == 0
    rc = main(["--resume", ck, *RESUME, "--backend", backend, "--metrics", m2,
               "--checkpoint", ck, *extra])
    assert rc == 0
    return _lines(m1), _lines(m2), ck


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _run(jcli.main, str(tmp_path_factory.mktemp("jax")), "cell")


@pytest.mark.parametrize("kw", [
    dict(steps=600, chunk=20, render_every=10),
    dict(steps=600, chunk=20, metrics_every=20),
    dict(steps=600, chunk=20, metrics_every=20, render_every=10),
    dict(steps=600, chunk=20, render_every=30),
    dict(steps=600, chunk=24, metrics_every=36),
    dict(steps=600, chunk=20, render_every=7),
    dict(steps=600, chunk=20),
    dict(steps=5, chunk=20),
])
def test_pick_chunk_matches_jax(kw):
    argv = []
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    want = jcli._pick_chunk(jcli.build_parser().parse_args(argv))
    assert cli._pick_chunk(cli.build_parser().parse_args(argv)) == want


def test_run_and_resume_give_the_jax_records(tmp_path, jax_run):
    run, resumed, ck = _run(cli.main, str(tmp_path), "window",
                            ["--device", "cpu"])
    jrun, jresumed, _ = jax_run
    for mine, theirs in ((run, jrun), (resumed, jresumed)):
        assert [sorted(r) for r in mine] == [sorted(r) for r in theirs]
        assert [r["event"] for r in mine] == [r["event"] for r in theirs]
    assert [r["step"] for r in run if r["event"] == "progress"] == [2, 4]
    assert [r["step"] for r in resumed if r["event"] == "progress"] == [6]
    prog = [r for r in run if r["event"] == "progress"]
    assert all(not r["nan_detected"] and r["n_escaped"] == 0 for r in prog)
    assert all(r["n_overflow"] == r["plan_overflow"] == 0 for r in prog)
    assert run[0]["device"] == "cpu" and run[-1]["frames"] == 3
    assert sorted(os.listdir(tmp_path / "fr")) == [
        "frame_000000.png", "frame_000002.png", "frame_000004.png"]
    assert open(tmp_path / "a.gif", "rb").read(6) == b"GIF89a"
    cfg, state = checkpoint.load(ck, device="cpu")
    assert int(state.step) == 6 and cfg.n == 256


def test_resume_continues_a_jax_checkpoint(tmp_path, jax_run):
    metrics = str(tmp_path / "m")
    ck = str(tmp_path / "ck.npz")
    rc = cli.main(["--resume", jax_run[2], "--steps", "4", "--chunk", "2",
                   "--device", "cpu", "--metrics", metrics,
                   "--checkpoint", ck, "--checkpoint-every", "2"])
    assert rc == 0
    steps = [r["step"] for r in _lines(metrics) if r["event"] == "progress"]
    assert steps == [8, 10]  # the JAX run and its resume ended at step 6
    assert int(checkpoint.load(ck, device="cpu")[1].step) == 10


def test_run_at_a_scaled_wall_and_its_resume(tmp_path):
    """The README's 1M command (`--wall 4.64 --grid-width 29`) at n = 2048
    on the CPU, with frames, a GIF and a checkpoint, then a resume that
    ends on a partial chunk: rc 0, every record's counters 0."""
    ck, m1, m2 = (str(tmp_path / f) for f in ("ck.npz", "m1", "m2"))
    assert cli.main(["--scene", "dam_break", "--n", "2048", "--wall", "4.64",
                     "--grid-width", "29", "--steps", "4", "--chunk", "2",
                     "--metrics-every", "2", "--render-every", "2",
                     "--width", "64", "--height", "48", "--out",
                     str(tmp_path / "fr"), "--gif", str(tmp_path / "a.gif"),
                     "--checkpoint", ck, "--device", "cpu",
                     "--metrics", m1]) == 0
    cfg, state = checkpoint.load(ck, device="cpu")
    assert (cfg.n, cfg.wall, cfg.grid_width, cfg.nb_grid_width) == (
        2048, 4.64, 29, 51)
    assert ((state.x >= 0) & (state.x <= 4.64)).all()
    assert sorted(os.listdir(tmp_path / "fr")) == [
        "frame_000000.png", "frame_000002.png", "frame_000004.png"]
    assert open(tmp_path / "a.gif", "rb").read(6) == b"GIF89a"
    assert cli.main(["--resume", ck, "--steps", "3", "--chunk", "2",
                     "--metrics-every", "2", "--device", "cpu",
                     "--metrics", m2, "--checkpoint", ck]) == 0
    run, resumed = _lines(m1), _lines(m2)
    assert [r["step"] for r in resumed if r["event"] == "progress"] == [6, 7]
    prog = [r for r in run + resumed if r["event"] == "progress"]
    assert all(r["n_overflow"] == r["plan_overflow"] == 0
               and not r["nan_detected"] and r.get("n_escaped", 0) == 0
               for r in prog)
    assert sum("mean_density" in r for r in prog) == 3
    assert run[-1]["event"] == resumed[-1]["event"] == "done"
    assert int(checkpoint.load(ck, device="cpu")[1].step) == 7


def test_nan_checkpoint_aborts_with_rc2(tmp_path):
    cfg = default_config(n=256)
    state = spawn(cfg, "standard", seed=0, device="cpu")
    x = state.x.clone()
    x[3, 2] = float("nan")
    ck = str(tmp_path / "nan.npz")
    checkpoint.save(ck, cfg, state._replace(x=x))
    metrics = str(tmp_path / "m")
    rc = cli.main(["--resume", ck, "--steps", "4", "--chunk", "2",
                   "--device", "cpu", "--metrics", metrics])
    assert rc == 2
    last = _lines(metrics)[-1]
    assert last["event"] == "progress" and last["nan_detected"]


def test_overflow_gate(tmp_path, monkeypatch):
    """Nonzero overflow aborts rc=2 unless --allow-overflow. The port's
    plan cannot overflow, so a plan that reports one stands in."""
    real = tstep.cuda_pbf.build_plan

    def overflowing(cfg, sorted_cid):
        plan = real(cfg, sorted_cid)
        return plan._replace(n_overflow=torch.ones_like(plan.n_overflow))

    monkeypatch.setattr(tstep.cuda_pbf, "build_plan", overflowing)
    base = ["--n", "256", "--steps", "4", "--chunk", "2", "--device", "cpu",
            "--metrics-every", "0"]
    m1, m2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    assert cli.main(base + ["--metrics", m1]) == 2
    assert _lines(m1)[-1]["plan_overflow"] == 2  # summed over the chunk
    assert cli.main(base + ["--metrics", m2, "--allow-overflow"]) == 0
    assert _lines(m2)[-1]["event"] == "done"


def test_refusals_exit_rc2(tmp_path, monkeypatch):
    gif = str(tmp_path / "a.gif")
    assert cli.main(["--n", "256", "--steps", "2", "--device", "cpu",
                     "--gif", gif]) == 2
    assert not os.path.exists(gif)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--n", "256", "--steps", "2"]) == 2  # --device cuda


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    rc = cli.main(["--n", "256", "--steps", "2", "--chunk", "2", "--device",
                   "cpu", "--metrics", str(tmp_path / "m"), "--profile",
                   str(prof)])
    assert rc == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_dense_backend_runs_and_matches_the_window_backend(tmp_path):
    """Both backends from one checkpoint, 2 steps: the same particles."""
    ck = str(tmp_path / "ck.npz")
    cfg = default_config(n=256)
    checkpoint.save(ck, cfg, spawn(cfg, "standard", seed=4, device="cpu"))
    out = {}
    for backend in ("window", "dense"):
        path = str(tmp_path / f"{backend}.npz")
        assert cli.main(["--resume", ck, "--steps", "2", "--chunk", "2",
                         "--backend", backend, "--device", "cpu",
                         "--metrics", str(tmp_path / backend),
                         "--checkpoint", path]) == 0
        _, st = checkpoint.load(path, device="cpu")
        out[backend] = st.x.numpy()[np.argsort(st.ids.numpy())]
    np.testing.assert_allclose(out["window"], out["dense"], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the cell backend, the sharded path, JAX files with another own
# ---------------------------------------------------------------------------

def _small_table_ckpt(tmp_path, **kw):
    """A checkpoint whose config has a small cell table (capacity 16), so
    the cell backend's plain passes stay cheap on the CPU."""
    ck = str(tmp_path / "small.npz")
    cfg = default_config(n=256, cell_capacity=16, block=16, **kw)
    checkpoint.save(ck, cfg, spawn(cfg, "dam_break", seed=4, device="cpu"))
    return ck


def test_cell_backend_runs_and_matches_the_window_backend(tmp_path):
    ck = _small_table_ckpt(tmp_path)
    out = {}
    for backend in ("window", "cell"):
        path = str(tmp_path / f"{backend}.npz")
        metrics = str(tmp_path / backend)
        assert cli.main(["--resume", ck, "--steps", "2", "--chunk", "2",
                         "--backend", backend, "--device", "cpu",
                         "--metrics", metrics, "--checkpoint", path]) == 0
        prog = [r for r in _lines(metrics) if r["event"] == "progress"]
        assert prog[-1]["n_overflow"] == 0
        _, st = checkpoint.load(path, device="cpu")
        out[backend] = st.x.numpy()[np.argsort(st.ids.numpy())]
    np.testing.assert_allclose(out["cell"], out["window"], rtol=1e-4,
                               atol=1e-5)


def test_table_overflow_exits_rc2(tmp_path):
    """A cell table of 32 rows drops particles: table_overflow, rc 2."""
    ck = _small_table_ckpt(tmp_path, max_occupied_cells=32)
    base = ["--resume", ck, "--steps", "2", "--chunk", "2", "--backend",
            "cell", "--device", "cpu", "--metrics-every", "0"]
    m1, m2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    assert cli.main(base + ["--metrics", m1]) == 2
    last = _lines(m1)[-1]
    assert last["event"] == "progress" and last["n_overflow"] > 0
    assert last["plan_overflow"] == 0
    assert cli.main(base + ["--metrics", m2, "--allow-overflow"]) == 0


MESH = ["--scene", "dam_break", "--n", "512", "--chunk", "2",
        "--metrics-every", "2"]


def test_fake_devices_run_to_the_end_and_resume(tmp_path):
    """--fake-devices 2 (two gloo ranks on the CPU) with metrics, frames, a
    GIF and a checkpoint, then a resume of it; against the single-device
    path from the same spawn."""
    ck, m1, m2, ms = (str(tmp_path / f) for f in ("ck.npz", "m1", "m2",
                                                  "ms"))
    assert cli.main(MESH + ["--steps", "4", "--fake-devices", "2",
                            "--render-every", "2", "--width", "64",
                            "--height", "48", "--out", str(tmp_path / "fr"),
                            "--gif", str(tmp_path / "a.gif"),
                            "--checkpoint", ck, "--metrics", m1]) == 0
    run = _lines(m1)
    assert [r["event"] for r in run] == ["start", "progress", "progress",
                                         "done"]
    assert run[0]["devices"] == 2 and run[0]["device"] == "cpu"
    prog = [r for r in run if r["event"] == "progress"]
    for r in prog:
        assert r["overflows"] == [0, 0, 0, 0] and not r["nan_detected"]
        assert len(r["per_shard_active"]) == 2
        assert sum(r["per_shard_active"]) == 512
        assert 0.5 < r["balance_min_over_mean"] <= 1.0
    assert sorted(os.listdir(tmp_path / "fr")) == [
        "frame_000000.png", "frame_000002.png", "frame_000004.png"]
    assert open(tmp_path / "a.gif", "rb").read(6) == b"GIF89a"
    assert int(checkpoint.load(ck, device="cpu")[1].step) == 4

    assert cli.main(["--resume", ck, "--steps", "2", "--chunk", "2",
                     "--fake-devices", "2",
                     "--metrics", m2, "--checkpoint", ck]) == 0
    assert [r["step"] for r in _lines(m2)
            if r["event"] == "progress"] == [6]
    _, mesh = checkpoint.load(ck, device="cpu")
    assert int(mesh.step) == 6
    assert torch.equal(mesh.ids, torch.arange(512, dtype=torch.int32))

    single = str(tmp_path / "single.npz")
    assert cli.main(MESH + ["--steps", "6", "--device", "cpu",
                            "--metrics", ms, "--checkpoint", single]) == 0
    _, ref = checkpoint.load(single, device="cpu")
    x_ref = ref.x.numpy()[np.argsort(ref.ids.numpy())]
    np.testing.assert_allclose(mesh.x.numpy(), x_ref, rtol=1e-4, atol=1e-5)
    dens = {r["step"]: r["mean_density"] for r in _lines(ms)
            if "mean_density" in r}
    for r in prog:
        assert r["mean_density"] == pytest.approx(dens[r["step"]], rel=1e-4)


def _mark_compact_tier(monkeypatch, column=None):
    """Make the compact tier recognisable (mig_capacity 256, which one rank
    never reads) and, when `column` is given, report one overflow of that
    stats column on every step of it; with column None, on every step of
    every tier."""
    real_compact = sharded.ParallelConfig.compact
    real_step = sharded._shard_step

    def compact(*a, **k):
        return dataclasses.replace(real_compact(*a, **k), mig_capacity=256)

    def step(cfg, pcfg, *rest):
        out = real_step(cfg, pcfg, *rest)
        col = 3 if column is None else column
        if column is None or pcfg.mig_capacity == 256:
            stats = out[4].clone()
            stats[col] += 1
            out = (*out[:4], stats, out[5])
        return out

    monkeypatch.setattr(sharded.ParallelConfig, "compact",
                        staticmethod(compact))
    monkeypatch.setattr(sharded, "_shard_step", step)


ONE_RANK = ["--devices", "1", "--device", "cpu", "--n", "256", "--steps",
            "6", "--chunk", "2", "--metrics-every", "2"]


def test_retier_then_fallback_on_ghost_overflow(tmp_path, monkeypatch):
    """Ghost (or plan/table) overflow on the compact tier falls back to the
    spawn tier and the run goes on. The overflow is reported by a wrapped
    step: one rank cannot overflow its ghost buffer."""
    _mark_compact_tier(monkeypatch, column=3)
    m = str(tmp_path / "m")
    assert cli.main(ONE_RANK + ["--retier-at", "2", "--retier-geom",
                                "own=128", "--metrics", m]) == 0
    recs = _lines(m)
    assert [r["event"] for r in recs] == [
        "start", "progress", "retier", "progress", "tier_fallback",
        "progress", "done"]
    retier = recs[2]
    assert retier["step"] == 2 and retier["geom"][1]["own"] == 128
    assert recs[3]["overflows"] == [0, 0, 2, 0]
    assert recs[4]["overflows"] == [0, 0, 2, 0]
    assert recs[5]["overflows"] == [0, 0, 0, 0]
    assert "mean_density" in recs[1] and "per_shard_active" in recs[1]


@pytest.mark.parametrize("column", [1, 2], ids=["migration", "merge"])
def test_migration_or_merge_overflow_on_the_compact_tier_exits_rc2(
        tmp_path, monkeypatch, column):
    """Migration and merge overflow drop particles: on the compact tier too
    they abort (JAX falls back and carries on), unless --allow-overflow."""
    _mark_compact_tier(monkeypatch, column=column)
    m = str(tmp_path / "m")
    assert cli.main(ONE_RANK + ["--retier-at", "2", "--metrics", m]) == 2
    last = _lines(m)[-1]
    assert last["event"] == "progress" and last["step"] == 4
    assert last["overflows"][column - 1] == 2
    assert cli.main(ONE_RANK + ["--retier-at", "2", "--metrics",
                                str(tmp_path / "m2"),
                                "--allow-overflow"]) == 0


def test_spawn_tier_overflow_exits_rc2(tmp_path, monkeypatch):
    _mark_compact_tier(monkeypatch)
    m = str(tmp_path / "m")
    assert cli.main(ONE_RANK + ["--metrics", m]) == 2
    assert _lines(m)[-1]["overflows"] == [0, 0, 2, 0]


def test_sharded_refusals_exit_rc2(tmp_path):
    """The sharded runner's refusals: no dense decomposition, a
    --retier-geom key that neither package's geometry has, a value that is
    not an integer. (JAX's TPU-only tier flags run with a note:
    test_jax_tier_flags_run_with_a_note.)"""
    m = str(tmp_path / "m")
    for extra in (["--backend", "dense"], ["--retier-geom", "bogus=1"],
                  ["--retier-geom", "own=x"], ["--retier-geom", "cc_d=x"]):
        assert cli.main(ONE_RANK + extra + ["--metrics", m]) == 2, extra
    assert not os.path.exists(m)
    # --device cuda (the default) with no card
    assert cli.main(["--devices", "2", "--n", "256", "--steps", "2"]) == 2


TPU_GEOM = "cc_d=512,cc_p=256,nbuf=8,gb=16,maxlanes=31744,chains_d=3," \
    "chains_p=3,ncopies=4"


@pytest.mark.parametrize("extra,notes,own", [
    (["--retier-maxlanes", "49152"], ["--retier-maxlanes 49152"], 64),
    (["--retier-geom", "cc_d=512"], ["cc_d=512"], 64),
    (["--retier-geom", "own=96"], ["own 96"], 64),
    (["--retier-geom", TPU_GEOM + ",own=128"], TPU_GEOM.split(","), 128),
], ids=["maxlanes", "cc_d", "own96", "every_tpu_key"])
def test_jax_tier_flags_run_with_a_note(tmp_path, capfd, extra, notes, own):
    """The JAX tier flags of docs/SCALING.md carry across under
    interop.config_from_fields' rule: the TPU kernels' knobs are dropped
    and an own without a kernel runs the port's default, each with a
    note; the run re-tiers in the geometry that is left."""
    m = str(tmp_path / "m")
    assert cli.main(ONE_RANK + ["--retier-at", "2", *extra,
                                "--metrics", m]) == 0
    err = capfd.readouterr().err
    for note in notes:
        assert note in err, (note, err)
    retier, = [r for r in _lines(m) if r["event"] == "retier"]
    assert retier["step"] == 2 and retier["geom"][1]["own"] == own
    assert retier["geom"][1]["seg"] == retier["geom"][0]["seg"]


def test_a_jax_checkpoint_with_own_96_loads_and_runs(tmp_path, capfd):
    """JAX allows own 96; the port has no kernel for it, so it runs its
    default own, with a note on stderr, and keeps every other field."""
    jcfg = jpbf.default_config(n=256, geom=JKernelGeometry(own=96),
                               dt=0.008)
    ck = str(tmp_path / "own96.npz")
    jcheckpoint.save(ck, jcfg, jpbf.spawn(jcfg, "dam_break", seed=1))
    cfg, state = checkpoint.load(ck, device="cpu")
    assert "own 96" in capfd.readouterr().err
    assert cfg.geom.own == 64 and cfg.dt == 0.008 and cfg.n == 256
    state = tstep.make_step(cfg, "window", device="cpu")(state)
    assert torch.isfinite(state.x).all()
    metrics = str(tmp_path / "m")
    assert cli.main(["--resume", ck, "--steps", "2", "--chunk", "2",
                     "--device", "cpu", "--metrics", metrics]) == 0
    assert "own 96" in capfd.readouterr().err
    assert [r["step"] for r in _lines(metrics)
            if r["event"] == "progress"] == [2]
    with pytest.raises(ValueError):
        interop.KernelGeometry(own=96).validate()


# ---------------------------------------------------------------------------
# the two tiers on gloo ranks (--fake-devices 2)
# ---------------------------------------------------------------------------

TIER_RUN = MESH + ["--chunk", "4", "--metrics-every", "4",
                   "--fake-devices", "2"]


def _tier_capacities(pcfg):
    return [pcfg.capacity, pcfg.ghost_capacity, pcfg.mig_capacity]


def _retier_capacities(record):
    return [list(x) for x in zip(record["capacity"], record["ghost_capacity"],
                                 record["mig_capacity"])]


def test_fake_devices_retier_and_a_resume_past_it(tmp_path):
    """--retier-at 4 on two gloo ranks with the JAX tier flags: the retier
    record between the two tiers' progress records, its capacities those
    of ParallelConfig.create on the spawn and .compact on the state at
    step 4; a resume of step 4's checkpoint past --retier-at re-tiers at
    once and ends in the same bits."""
    ck4, ck8, ck8b = (str(tmp_path / f) for f in ("4.npz", "8.npz", "8b.npz"))
    m1, m2, m3 = (str(tmp_path / f) for f in ("m1", "m2", "m3"))
    assert cli.main(TIER_RUN + ["--steps", "4", "--checkpoint", ck4,
                                "--metrics", m1]) == 0
    assert cli.main(TIER_RUN + ["--steps", "8", "--retier-at", "4",
                                "--retier-maxlanes", "49152", "--retier-geom",
                                "cc_d=512", "--checkpoint", ck8,
                                "--metrics", m2]) == 0
    assert cli.main(["--resume", ck4, "--steps", "4", "--chunk", "4",
                     "--metrics-every", "4", "--fake-devices", "2",
                     "--retier-at", "4", "--checkpoint", ck8b,
                     "--metrics", m3]) == 0
    cfg, st4 = checkpoint.load(ck4, device="cpu")
    spawn_tier = sharded.ParallelConfig.create(
        cfg, 2, state=spawn(cfg, "dam_break", seed=0, device="cpu"))
    resumed_tier = sharded.ParallelConfig.create(cfg, 2, state=st4)
    compact = sharded.ParallelConfig.compact(cfg, 2, state=st4,
                                             prior=spawn_tier)
    assert compact.capacity < spawn_tier.capacity

    run, resumed = _lines(m2), _lines(m3)
    assert [r["event"] for r in run] == ["start", "progress", "retier",
                                         "progress", "done"]
    assert [r["event"] for r in resumed] == ["start", "retier", "progress",
                                             "done"]
    for records, old in ((run, spawn_tier), (resumed, resumed_tier)):
        retier = records[[r["event"] for r in records].index("retier")]
        assert retier["step"] == 4
        assert _retier_capacities(retier) == [_tier_capacities(old),
                                              _tier_capacities(compact)]
        assert retier["geom"][0] == retier["geom"][1]
        prog = [r for r in records if r["event"] == "progress"]
        assert prog[-1]["step"] == 8
        for r in prog:
            assert r["overflows"] == [0, 0, 0, 0] and not r["nan_detected"]
            assert sum(r["per_shard_active"]) == cfg.n
            assert "mean_density" in r
    a, b = (checkpoint.load(p, device="cpu")[1] for p in (ck8, ck8b))
    assert int(a.step) == int(b.step) == 8
    assert all(torch.equal(s, t) for s, t in zip(a[:3], b[:3]))


OVERFLOW_COLUMN_ENV = "PBF_TEST_OVERFLOW_COLUMN"
COUNTS_DIR_ENV = "PBF_TEST_COUNTS_DIR"


def _overflowing_mesh_rank(group, device, workdir, *job) -> None:
    """cli._mesh_rank with one overflow of the stats column that
    OVERFLOW_COLUMN_ENV names added to every step of the compact tier (a
    tier made by ParallelConfig.compact), and the rollouts it builds and
    releases counted into COUNTS_DIR_ENV's directory."""
    column = int(os.environ[OVERFLOW_COLUMN_ENV])
    real_compact, real_step = (sharded.ParallelConfig.compact,
                               sharded._shard_step)
    real_rollout, real_release = (sharded.make_sharded_rollout,
                                  sharded.ShardedRollout.release)
    compact_tiers, counts = [], {"rollouts": 0, "releases": 0}

    def compact(*args, **kwargs):
        compact_tiers.append(real_compact(*args, **kwargs))
        return compact_tiers[-1]

    def step(cfg, pcfg, *rest):
        out = real_step(cfg, pcfg, *rest)
        if any(pcfg is c for c in compact_tiers):
            stats = out[4].clone()
            stats[column] += 1
            out = (*out[:4], stats, out[5])
        return out

    def rollout(*args, **kwargs):
        counts["rollouts"] += 1
        return real_rollout(*args, **kwargs)

    def release(self):
        counts["releases"] += 1
        real_release(self)

    sharded.ParallelConfig.compact = staticmethod(compact)
    sharded._shard_step = step
    sharded.make_sharded_rollout = rollout
    sharded.ShardedRollout.release = release
    cli._mesh_rank(group, device, workdir, *job)
    with open(os.path.join(os.environ[COUNTS_DIR_ENV],
                           f"rank{group.rank}.json"), "w") as f:
        json.dump(counts, f)


@pytest.mark.parametrize("column,rc", [(3, 0), (1, 2)],
                         ids=["ghost_falls_back", "migration_exits_rc2"])
def test_fake_devices_compact_tier_overflow(tmp_path, monkeypatch, column,
                                            rc):
    """Ghost overflow on the compact tier falls back to a spawn tier made
    from the current state (a tier_fallback record, a warning, one more
    rollout a rank, clean records after it, rc 0); migration overflow drops
    particles and exits 2."""
    monkeypatch.setattr(cli, "_mesh_rank", _overflowing_mesh_rank)
    monkeypatch.setenv(OVERFLOW_COLUMN_ENV, str(column))
    monkeypatch.setenv(COUNTS_DIR_ENV, str(tmp_path))
    m = str(tmp_path / "m")
    assert cli.main(TIER_RUN + ["--steps", "12", "--retier-at", "4",
                                "--metrics", m]) == rc
    records = _lines(m)
    events = [r["event"] for r in records]
    flagged = [0, 0, 0, 0]
    flagged[column - 1] = 2 * 4  # two ranks, four steps
    assert records[3]["event"] == "progress" and records[3]["step"] == 8
    assert records[3]["overflows"] == flagged
    if rc == 2:
        assert events == ["start", "progress", "retier", "progress"]
        return
    assert events == ["start", "progress", "retier", "progress",
                      "tier_fallback", "progress", "done"]
    fallback = records[4]
    assert fallback["step"] == 8 and fallback["overflows"] == flagged
    assert records[5]["overflows"] == [0, 0, 0, 0]
    assert sum(records[5]["per_shard_active"]) == 512
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            assert json.load(f) == {"rollouts": 3, "releases": 2}
