"""The rollout of the port: a step that builds no tensor from host values,
the body a card captures as a CUDA graph (run here eagerly, and through
the rollout's graph path with a stand-in graph), on every backend, the
rollout against the Stepper loop and against JAX, partial chunks on one
rollout, and how a captured launch is counted."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import pdb_sph_tpu as jpbf
from pdb_sph_tpu.core.step import make_rollout as jmake_rollout
from pdb_sph_tpu_torch import cli, default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.ops import cuda_pbf, integrate
from pdb_sph_tpu_torch.parallel import sharded
from pdb_sph_tpu_torch.utils import timing
from test_torch_ranks import _EagerGraph, _NoHostValues

torch.set_num_threads(1)

N = 512


def _dam(n: int = N, backend: str = "window"):
    # the cell backend's plain passes cost max_occ x 27 x capacity^2 a
    # pass: a table of 512 x 8 holds this dam (at most 3 a cell)
    table = (dict(max_occupied_cells=512, cell_capacity=8, block=8)
             if backend == "cell" else {})
    cfg = default_config(n=n, **table)
    return cfg, spawn(cfg, "dam_break", seed=0, device="cpu")


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _equal(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b))


def _stepper_loop(cfg, state, steps: int, backend: str = "window"):
    """`steps` eager Stepper.step calls from `state`, stats summed."""
    stepper = tstep.Stepper(cfg, backend, device="cpu")
    total = torch.zeros((3,), dtype=torch.int32)
    for _ in range(steps):
        state, stats = stepper.step(state, with_stats=True)
        total += stats
    return state, total


def _one_rank(cfg, st):
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    return pcfg, sharded.distribute(cfg, pcfg, st, device="cpu")


def _no_host_tensors(*args, **kwargs):
    raise AssertionError("a step built a tensor from host values")


@pytest.mark.parametrize("path", ["window", "cell", "dense", "single"])
def test_a_step_builds_no_tensor_from_host_values(monkeypatch, path):
    """On a card such a tensor is a copy that waits for the queued work:
    the step's constants are made when its stepper is built."""
    cfg, st = _dam(backend=path)
    integrate.gravity_vector.cache_clear()
    cuda_pbf.window_offsets.cache_clear()
    if path != "single":
        stepper = tstep.Stepper(cfg, path, device="cpu")
        monkeypatch.setattr(torch, "tensor", _no_host_tensors)
        out, stats = stepper.step(st, with_stats=True)
        tstep.diagnostics_fn(cfg, out)
    else:
        pcfg, sst = _one_rank(cfg, st)
        stepper = sharded.ShardedStepper(cfg, pcfg, device="cpu")
        monkeypatch.setattr(torch, "tensor", _no_host_tensors)
        _, stats, _ = stepper.step(sst)
    assert not stats[1:].any()


def test_rollout_is_the_stepper_loop_and_leaves_the_input_alone():
    cfg, st = _dam()
    before = _clone(st)
    rollout = tstep.make_rollout(cfg, "window", 4, with_stats=True,
                                 device="cpu")
    out, total = rollout(st)
    ref, ref_total = _stepper_loop(cfg, st, 4)
    assert _equal(out, ref) and torch.equal(total, ref_total)
    assert int(out.step) == 4 and _equal(st, before)
    ptrs = {t.data_ptr() for t in rollout.stepper.bufs}
    assert not ptrs & {t.data_ptr() for t in out}
    first = _clone(out)
    for t in out:
        t.zero_()
    again, again_total = rollout(st)
    assert _equal(again, first) and torch.equal(again_total, ref_total)


@pytest.mark.parametrize("path", ["window", "cell", "dense", "single"])
def test_the_captured_body_run_eagerly_is_the_stepper_loop(path):
    """The function a card captures, with its copy-back into the static
    inputs, over 5 steps: bitwise the eager loop."""
    cfg, st = _dam(backend=path)
    if path != "single":
        static = tuple(t.clone() for t in st)
        acc = (torch.zeros((3,), dtype=torch.int32),)
        stepper = tstep.Stepper(cfg, path, device="cpu")
        for _ in range(5):
            tstep.step_into(stepper, static, acc)
        ref, ref_total = _stepper_loop(cfg, st, 5, path)
        assert _equal(static, ref) and torch.equal(acc[0], ref_total)
        assert ref_total.tolist() == [0, 0, 0]
        return
    pcfg, sst = _one_rank(cfg, st)
    static = tuple(t.clone() for t in sst)
    acc = (torch.zeros((5,), dtype=torch.int32),
           torch.zeros((3,), dtype=torch.float32))
    stepper = sharded.ShardedStepper(cfg, pcfg, device="cpu")
    for _ in range(5):
        sharded.step_into(stepper, static, acc)
    eager = sharded.ShardedStepper(cfg, pcfg, device="cpu")
    ref, stats, diags = sst, [], []
    for _ in range(5):
        ref, s, d = eager.step(ref)
        stats.append(s)
        diags.append(d)
    want = torch.stack(stats).sum(0)
    want[0] = stats[-1][0]
    assert _equal(static, ref)
    assert torch.equal(acc[0], want)
    assert torch.equal(acc[1], torch.stack(diags).amax(0))
    one, total, dmax = sharded.make_sharded_rollout(
        cfg, pcfg, None, "window", 5, "cpu")(sst)
    assert _equal(one, ref) and torch.equal(total[0], want)
    assert torch.equal(dmax[0], acc[1])


@pytest.mark.parametrize("backend", ["window", "cell", "dense"])
def test_the_rollout_graph_path_is_the_stepper_loop(monkeypatch, backend):
    """A card captures every backend's Rollout: its graph path, with a
    stand-in graph whose replay runs the captured body, over a chunk and a
    partial chunk, gives the eager Stepper loop's bits and stats sum, and
    builds no tensor from host values (which a capture refuses)."""
    cfg, st = _dam(backend=backend)
    monkeypatch.setattr(tstep, "CapturedStep", _EagerGraph)
    rollout = tstep.make_rollout(cfg, backend, 3, with_stats=True,
                                 device="cpu")
    assert not rollout.graphed
    rollout.graphed = True
    got = want = st
    for steps in (3, 2):
        with _NoHostValues():
            got, total = rollout(got, steps)
        want, want_total = _stepper_loop(cfg, want, steps, backend)
        assert _equal(got, want) and torch.equal(total, want_total)
        assert total.tolist() == [0, 0, 0]
    assert int(got.step) == 5


def test_a_partial_chunk_runs_on_the_same_rollout():
    cfg, st = _dam()
    rollout = tstep.make_rollout(cfg, "window", 5, with_stats=True,
                                 device="cpu")
    stepper = rollout.stepper
    ptrs = [t.data_ptr() for t in stepper.bufs]
    out, total = rollout(st, 2)
    ref, ref_total = _stepper_loop(cfg, st, 2)
    assert _equal(out, ref) and torch.equal(total, ref_total)
    assert rollout.stepper is stepper
    assert [t.data_ptr() for t in stepper.bufs] == ptrs
    with pytest.raises(ValueError):
        rollout(st, 0)
    pcfg, sst = _one_rank(cfg, st)
    roll = sharded.make_sharded_rollout(cfg, pcfg, None, "window", 5, "cpu")
    two, _, _ = roll(sst, 2)
    assert torch.equal(two.x, ref.x) and torch.equal(two.ids, ref.ids)


@pytest.mark.parametrize("mesh", [False, True])
def test_a_runner_run_builds_one_stepper(tmp_path, monkeypatch, mesh):
    """Chunks of 2, 2 and 1 steps all run on the rollout built first."""
    cls = sharded.ShardedStepper if mesh else tstep.Stepper
    built = []
    init = cls.__init__

    def counting(self, *args, **kwargs):
        built.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(cls, "__init__", counting)
    argv = ["--n", "256", "--steps", "5", "--chunk", "2", "--metrics-every",
            "2", "--device", "cpu", "--metrics", str(tmp_path / "m")]
    assert cli.main(argv + (["--devices", "1"] if mesh else [])) == 0
    assert len(built) == 1


def test_a_captured_launch_counts_at_each_replay(monkeypatch):
    """While a stream captures, a wrapper's launch records a kernel that
    runs at each replay: it counts into the capture's tally, which
    add_replays multiplies into LAUNCHES; a capture outside
    captured_launches() raises."""
    cfg, _ = _dam()
    n_pad = cuda_pbf.pad_to_chunks(cfg, cfg.n)
    p4 = torch.zeros((n_pad, 4))
    sorted_cid = torch.full((n_pad,), cfg.num_nb_cells, dtype=torch.int32)
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    scratch = cuda_pbf.PairScratch(
        torch.zeros((cuda_pbf.ITEMS_PER_CHUNK * n_pad, 4)),
        torch.zeros((n_pad // cfg.geom.own + 2,), dtype=torch.int32))

    class Lib:
        @staticmethod
        def launch_project(*args):
            return 0

    kernels = type("K", (), {"lib": Lib, "check": lambda self, c, w: None})()
    monkeypatch.setattr(cuda_pbf, "_kernels_and_out",
                        lambda p, out: (kernels, out, 0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    launch = functools.partial(cuda_pbf._launch, "project", "launch_project",
                               cfg, p4, plan, cfg.n, torch.zeros_like(p4),
                               scratch, cuda_pbf.project_consts(cfg))
    cuda_pbf.reset_launches()
    with cuda_pbf.captured_launches() as captured:
        launch()
        launch()
    assert captured["project"] == 2 and cuda_pbf.LAUNCHES["project"] == 0
    cuda_pbf.add_replays(captured, 240)
    assert cuda_pbf.LAUNCHES["project"] == 480
    with pytest.raises(RuntimeError, match="captured_launches"):
        launch()
    cuda_pbf.reset_launches()


def test_kernel_busy_merges_overlapping_kernels(tmp_path):
    """The busy share of a profiler trace: overlapping kernels count once,
    the gaps between them are idle, events other than kernels are left
    out."""
    trace = tmp_path / "trace.json"
    events = [{"cat": "kernel", "name": "a", "ts": 0, "dur": 10},
              {"cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"cat": "kernel", "name": "a", "ts": 30, "dur": 10},
              {"cat": "cpu_op", "name": "c", "ts": 0, "dur": 100}]
    trace.write_text(json.dumps({"traceEvents": events}))
    r = timing.kernel_busy(trace)
    assert r["kernels"] == 3 and r["kernel_ms"] == pytest.approx(0.03)
    assert r["span_ms"] == pytest.approx(0.04)
    assert r["busy_ms"] == pytest.approx(0.025)
    assert r["busy_share"] == pytest.approx(0.625)
    assert r["by_name"][0][:2] == ("a", 2)
    trace.write_text(json.dumps({"traceEvents": events[3:]}))
    assert timing.kernel_busy(trace)["busy_share"] is None


def test_kernel_busy_reads_from_the_profiled_window_on(tmp_path):
    """Where the host opened the profiled window, a kernel that started
    before it (a barrier's, one rank waiting for another) is left out; the
    window's copy on the device's timeline opens nothing."""
    trace = tmp_path / "trace.json"
    events = [{"cat": "kernel", "name": "barrier", "ts": 0, "dur": 50},
              {"cat": "gpu_user_annotation", "name": timing.WINDOW,
               "ts": 10, "dur": 100},
              {"cat": "user_annotation", "name": timing.WINDOW, "ts": 60,
               "dur": 100},
              {"cat": "kernel", "name": "a", "ts": 70, "dur": 10},
              {"cat": "kernel", "name": "b", "ts": 90, "dur": 10}]
    trace.write_text(json.dumps({"traceEvents": events}))
    r = timing.kernel_busy(trace)
    assert r["kernels"] == 2 and r["kernel_ms"] == pytest.approx(0.02)
    assert r["span_ms"] == pytest.approx(0.03)
    assert r["busy_share"] == pytest.approx(2 / 3)
    assert [name for name, _, _ in r["by_name"]] == ["a", "b"]


def test_rollout_matches_jax_make_rollout():
    jcfg = jpbf.default_config(n=256)
    st = jpbf.spawn(jcfg, "standard", seed=1)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    mine = interop.state_from_numpy(st.x, st.v, st.ids, st.step, "cpu")
    a, a_stats = jmake_rollout(jcfg, "dense", 3, with_stats=True)(st)
    b, b_stats = tstep.make_rollout(cfg, "window", 3, with_stats=True,
                                    device="cpu")(mine)
    x, v, ids, step = interop.state_to_numpy(b)
    inv = np.argsort(ids)
    assert int(step) == int(a.step) == 3
    assert b_stats.tolist() == np.asarray(a_stats).tolist() == [0, 0, 0]
    np.testing.assert_allclose(x[inv], np.asarray(a.x), rtol=1e-4,
                               atol=1e-5)
    # v = (p - x) / dt: the positions' atol over dt
    np.testing.assert_allclose(v[inv], np.asarray(a.v), rtol=1e-4,
                               atol=1e-5 / cfg.dt)
