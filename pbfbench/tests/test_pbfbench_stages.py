"""The readers of the program's stage map and counters (stages.py) on
synthetic traces: the ops grouped by their graph launch's correlation, each
stage's busy time, the stages and the gaps tiling each replay, and no
number where the map and the trace disagree."""

import json
import types

import pytest

from pbfbench import harness, stages, trace

# a map as the program records it: (name, first node, node count)
Stage = types.SimpleNamespace
MAP = [("predict+cell_ids", 0, 2), ("sort+gather", 2, 1), ("plan", 3, 1),
       ("density", 4, 1), ("project", 5, 1), ("finalize", 6, 1),
       ("epilogue", 7, 1)]
NODES = 8


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _op_name(k: int) -> str:
    return ("void window_kernel<(Pass)0, 2>(Launch)" if k in (4, 5)
            else f"void small_kernel_{k}()")


def _events(replays=2, drop=None, pair_at=None, stall=0.0, lag=0.0,
            extra=False):
    """A window of 300 us a replay with `replays` graph launches, each
    replay's NODES ops of 4 us 10 us apart, in order (the op `drop` left out
    of the last replay, and with `extra` one more op in it; a pair kernel put
    at node `pair_at`; with `stall`, the ops from node 3 on `stall` us later,
    as under CUPTI; every op `lag` us later, as on a device clock behind the
    host's), and an eager copy beside them."""
    evs = [_ev("user_annotation", trace.WINDOW, 0.0, 300.0 * replays)]
    for r in range(replays):
        t0 = 20.0 + r * 300.0
        corr = 100 + r
        evs.append(_ev("cuda_runtime", stages.LAUNCH, t0 - 5.0, 10.0, corr))
        for k in range(NODES + (extra and r == replays - 1)):
            if r == replays - 1 and k == drop:
                continue
            name = ("void window_kernel<(Pass)2, 2>(Launch)" if k == pair_at
                    else _op_name(k))
            cat = "gpu_memcpy" if k == 7 else "kernel"
            evs.append(_ev(cat, name, t0 + 10.0 * k + stall * (k >= 3) + lag,
                           4.0, corr))
        evs.append(_ev("gpu_memcpy", "Memcpy DtoD", t0 + 150.0, 2.0, 999))
    return evs


@pytest.fixture
def program(monkeypatch, tmp_path):
    """The readers pointed at traces under tmp_path and at a program whose
    stage map is MAP and whose last session is `session["value"]`."""
    session = {"value": None}
    fake = types.SimpleNamespace(
        last_stage_map=lambda: [Stage(name=n, first=f, count=c)
                                for n, f, c in MAP],
        last_session=lambda: session["value"])
    monkeypatch.setattr(stages, "_timing", lambda: fake)
    monkeypatch.setattr(stages, "TRACES", tmp_path)
    stages._cache.clear()
    return session


def _ctx(tmp_path, evs, steps=2, calls=2, pairs=1000.0):
    path = tmp_path / "trace_cell.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    stages._cache.clear()
    t = harness.Traced(trace.window(trace.load(path)), calls=calls,
                       steps=steps)
    t.pairs_per_step = pairs
    return harness.Context(n=1000, iters=3, trace=t, window_s=1e-3,
                           calls_ms=[0.5] * calls, card="cpu")


def test_the_stages_are_their_ops_busy_time(program, tmp_path):
    ctx = _ctx(tmp_path, _events())
    ms = stages.stage_ms(ctx)
    # predict: nodes 0-1, 4 us each
    assert ms["predict+cell_ids"] == pytest.approx(8e-3)
    assert ms["density"] == ms["project"] == ms["epilogue"] \
        == pytest.approx(4e-3)
    assert ms["replay"] == pytest.approx(74e-3)
    # the 6 us after each of the first seven ops
    assert ms["gaps"] == pytest.approx(42e-3)
    assert sum(v for k, v in ms.items() if k not in ("replay", "replays")) \
        == pytest.approx(ms["replay"])
    assert ms["replays"] == 2
    read = {name: harness.reader(name)(ctx) for name in (
        "predict_ms_per_step", "sort_ms_per_step", "plan_ms_per_step",
        "finalize_ms_per_step")}
    assert read == pytest.approx({
        "predict_ms_per_step": 8e-3, "sort_ms_per_step": 4e-3,
        "plan_ms_per_step": 4e-3, "finalize_ms_per_step": 8e-3})
    # the eager copy of correlation 999 belongs to no replay
    assert [len(g) for g in stages.replays(
        stages.events(ctx), ctx.trace.window)] == [NODES, NODES]


def test_a_stall_inside_a_replay_is_a_gap_and_no_stage(program, tmp_path):
    """The device waiting for the host inside a replay (100 us before node
    3) lengthens the replay and its gaps, and no stage; overlapping ops
    count once."""
    ms = stages.stage_ms(_ctx(tmp_path, _events(stall=100.0)))
    assert ms == pytest.approx(stages.stage_ms(_ctx(tmp_path, _events()))
                               | {"replay": 174e-3, "gaps": 142e-3})
    ops = [_ev("kernel", "a", 0.0, 4.0), _ev("kernel", "b", 2.0, 4.0),
           _ev("kernel", "c", 10.0, 1.0), _ev("kernel", "d", 10.5, 0.2)]
    assert stages.busy_us(ops) == pytest.approx(7.0)


def test_no_number_where_a_replay_has_another_size(program, tmp_path):
    assert stages.stage_ms(_ctx(tmp_path, _events(drop=3))) is None
    assert harness.reader("plan_ms_per_step")(
        _ctx(tmp_path, _events(drop=7))) is None
    assert stages.stage_ms(_ctx(tmp_path, _events(replays=20, extra=True),
                                steps=20, calls=20)) is None


def test_a_replay_short_of_dropped_ops_is_left_out(program, tmp_path):
    """Of 20 replays one lacks an op (the profiler dropped its record): the
    means are taken over the other 19; ops that a lagging device clock puts
    after the window still belong to their launches."""
    whole = stages.stage_ms(_ctx(tmp_path, _events(replays=20), steps=20,
                                 calls=20))
    short = stages.stage_ms(_ctx(tmp_path, _events(replays=20, drop=3),
                                 steps=20, calls=20))
    assert whole["replays"] == 20 and short["replays"] == 19
    assert short == pytest.approx(whole | {"replays": 19})
    lagged = stages.stage_ms(_ctx(tmp_path, _events(replays=20, lag=250.0),
                                  steps=20, calls=20))
    assert lagged == pytest.approx(whole)


def test_no_number_where_a_pair_kernel_is_outside_the_solve(program,
                                                            tmp_path):
    assert stages.stage_ms(_ctx(tmp_path, _events(pair_at=3))) is None
    assert stages.stage_ms(_ctx(tmp_path, _events(pair_at=5))) is not None


def test_no_number_where_the_replays_are_not_the_steps(program, tmp_path):
    assert stages.stage_ms(_ctx(tmp_path, _events(), steps=3)) is None
    assert stages.stage_ms(_ctx(tmp_path, _events(replays=3), steps=2,
                                calls=3)) is None


def test_candidates_per_pair_reads_the_session(program, tmp_path):
    ctx = _ctx(tmp_path, _events())
    read = harness.reader("candidates_per_pair")
    assert read(ctx) is None
    program["value"] = {"steps": 2, "plan_candidates": 14_000}
    assert read(ctx) == pytest.approx(7.0)
    program["value"] = {"steps": 3, "plan_candidates": 21_000}
    assert read(ctx) is None


def test_rollout_host_ms_reads_the_untraced_calls(program, tmp_path):
    """The program's own mean host time of a call over the untraced window,
    only where it timed as many untraced calls as the window made."""
    ctx = _ctx(tmp_path, _events(), calls=2)
    read = harness.reader("rollout_host_ms_per_frame")
    assert read(ctx) is None
    session = {"steps": 2, "plan_candidates": 14_000, "untraced_calls": 2,
               "untraced_call_ms": 0.096}
    program["value"] = session
    assert read(ctx) == pytest.approx(0.096)
    program["value"] = session | {"untraced_calls": 3}
    assert read(ctx) is None
    program["value"] = session | {"steps": 3}
    assert read(ctx) is None


def test_no_number_from_a_program_without_the_map(monkeypatch, tmp_path):
    """Against a program with no stage map or session (an older checkout)
    every reader returns None, and none raises."""
    monkeypatch.setattr(stages, "TRACES", tmp_path)
    monkeypatch.setattr(stages, "_timing", lambda: None)
    ctx = _ctx(tmp_path, _events())
    for name in ("predict_ms_per_step", "sort_ms_per_step",
                 "plan_ms_per_step", "finalize_ms_per_step",
                 "candidates_per_pair"):
        assert harness.reader(name)(ctx) is None
    none = harness.Context(n=1000, iters=3, trace=None, window_s=0.0,
                           calls_ms=[], card="cpu")
    for name in ("predict_ms_per_step", "candidates_per_pair",
                 "rollout_host_ms_per_frame"):
        assert harness.reader(name)(none) is None
