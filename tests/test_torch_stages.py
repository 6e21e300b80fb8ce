"""What the port measures of itself: the stage marks of a step and the
stage map a capture builds from them, the plan-candidate counter, the
counters scoped to a profiler session, and the rollout's host spans.

No JAX here: the tests marked `card` run on a card with

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" \
        tests/test_torch_stages.py

(tests/conftest.py imports JAX, which the card's machine does not have),
and skip without one."""

import contextlib
import functools
import itertools
import json

import pytest
import torch

from pdb_sph_tpu_torch import default_config, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid
from pdb_sph_tpu_torch.ops.integrate import predict
from pdb_sph_tpu_torch.utils import timing

torch.set_num_threads(1)

N = 512


@pytest.fixture
def card():
    """The card, or skip: decided when a test asks, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _dam(n: int = N, device: str = "cpu", backend: str = "window"):
    # the cell backend's plain passes cost max_occ x 27 x capacity^2 a
    # pass: a table of 512 x 8 holds this dam at N (at most 3 a cell)
    table = (dict(max_occupied_cells=512, cell_capacity=8, block=8)
             if backend == "cell" else {})
    cfg = default_config(n=n, **table)
    return cfg, spawn(cfg, "dam_break", seed=0, device=device)


def _expected_stages(cfg, backend: str = "window") -> list[str]:
    if backend == "dense":
        return ["epilogue"]
    solve = (["solve"] if backend == "cell"
             else ["plan"] + ["density", "project"] * cfg.solver_iters)
    return (["predict+cell_ids", "sort+gather"] + solve
            + ["finalize", "epilogue"])


def test_the_window_step_marks_its_stages_in_order(monkeypatch):
    """The captured body (step_into) names its stages through the default
    mark while a stream captures, in the documented order; outside a
    capture, and outside stage_map(), the marks record nothing."""
    cfg, st = _dam()
    stepper = tstep.Stepper(cfg, "window", device="cpu")
    static = tuple(t.clone() for t in st)
    acc = (torch.zeros((3,), dtype=torch.int32),)
    nodes = itertools.count(5, 5)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    with timing.stage_map(count=lambda: next(nodes)) as stages:
        tstep.step_into(stepper, static, acc)  # not capturing: no marks
    assert stages == []
    capturing[0] = True
    tstep.step_into(stepper, static, acc)  # no stage_map(): no marks
    with timing.stage_map(count=lambda: next(nodes)) as stages:
        tstep.step_into(stepper, static, acc)
    want = _expected_stages(cfg)
    assert [s.name for s in stages] == want
    assert [s.count for s in stages] == [5] * len(want)
    assert timing.last_stage_map() == stages


def test_the_stage_map_is_built_from_planted_node_counts():
    """Cumulative node counts at each mark -> (stage, first, count): each
    stage owns the nodes added since the mark before it."""
    marks = [("predict+cell_ids", 12), ("sort+gather", 40), ("plan", 40),
             ("density", 41), ("project", 45), ("epilogue", 52)]
    assert timing.stage_ranges(marks) == [
        timing.Stage("predict+cell_ids", 0, 12),
        timing.Stage("sort+gather", 12, 28), timing.Stage("plan", 40, 0),
        timing.Stage("density", 40, 1), timing.Stage("project", 41, 4),
        timing.Stage("epilogue", 45, 7)]
    assert timing.stage_ranges([]) == []
    with pytest.raises(ValueError, match="fell"):
        timing.stage_ranges([("a", 3), ("b", 2)])


def _plan_pairs(cfg, state) -> int:
    """The (own row, candidate) pairs of the plan that a step from `state`
    builds, summed from its ranges."""
    p, _ = predict(cfg, state.x, state.v)
    sorted_cid, _ = tstep.sort_cells(cfg, hashgrid.cell_ids(cfg, p))
    ranges = cuda_pbf.build_plan(cfg, sorted_cid).ranges.long()
    return cfg.geom.own * int((ranges[..., 1] - ranges[..., 0]).sum())


def test_the_counter_sums_the_plans_candidate_pairs():
    """On the CPU Rollout, counters["plan_candidates"] is own x sum(end -
    start) of every step's plan, recomputed here from the same states; the
    states and the stats vector are bitwise those of steps that count
    nothing."""
    cfg, st = _dam()
    rollout = tstep.make_rollout(cfg, "window", 3, with_stats=True,
                                 device="cpu")
    got, stats = rollout(st)
    got, more = rollout(got, 2)
    want, total, pairs = st, None, 0
    n_pad = cuda_pbf.pad_to_chunks(cfg, cfg.n)
    bufs = tuple(torch.zeros((n_pad, 4)) for _ in range(2))
    for k in range(5):
        pairs += _plan_pairs(cfg, want)
        want, s = tstep.step_fn(cfg, "window", want, bufs, with_stats=True)
        total = s if k == 0 else total + s
        if k == 2:
            assert torch.equal(stats, total)
            total = torch.zeros_like(total)
    assert int(rollout.stepper.counters["plan_candidates"]) == pairs > 0
    assert rollout.stepped == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(more, total) and more.tolist() == [0, 0, 0]
    plan = cuda_pbf.build_plan(cfg, tstep.sort_cells(
        cfg, hashgrid.cell_ids(cfg, st.x))[0])
    r = plan.ranges.long()
    assert plan.n_candidates.dtype == torch.int64
    assert int(plan.n_candidates) == int((r[..., 1] - r[..., 0]).sum())


def test_the_session_counts_exactly_the_profiled_calls():
    """A profiler session around calls 2 and 3 of 5: last_session() gives
    those calls' steps and each counter's increase over them, closed at the
    first call after the session, or when read after the session; and the
    untraced calls timed before each session. An older session that
    another rollout left open does not displace them when it closes."""
    cfg, st = _dam()
    acts = [torch.profiler.ProfilerActivity.CPU]
    stale = tstep.make_rollout(cfg, "window", 1, device="cpu")
    with torch.profiler.profile(activities=acts):
        stale(st)
    rollout = tstep.make_rollout(cfg, "window", 2, with_stats=True,
                                 device="cpu")
    counters = rollout.stepper.counters
    st = rollout(st)[0]
    before = {k: int(c) for k, c in counters.items()}
    with torch.profiler.profile(activities=acts):
        st = rollout(st, 1)[0]
        st = rollout(st, 2)[0]
    after = {k: int(c) for k, c in counters.items()}
    st = rollout(st)[0]
    st = rollout(st)[0]
    got = timing.last_session()
    assert got.pop("untraced_call_ms") > 0
    assert got == {"steps": 3, "untraced_calls": 1,
                   **{k: after[k] - before[k] for k in counters}}
    assert got["pair_evals"] == 0
    assert after["plan_candidates"] > before["plan_candidates"]
    assert got["chunk_items_max"] >= 3 and got["pair_items"] >= 3
    # a session with no call after it is closed when it is read
    with torch.profiler.profile(activities=acts):
        rollout(st, 1)
    got = timing.last_session()
    assert got["steps"] == 1 and got["untraced_calls"] == 2
    assert timing.last_session() == got
    assert stale.session.start is None


def _spans(prof_path):
    events = json.loads(prof_path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events
                   if str(e.get("name", "")).startswith("pbf.rollout")),
                  key=lambda s: (s[1], -s[2]))


def _no_record_function(name, *args):
    raise AssertionError(f"record_function({name!r}) outside a session")


@pytest.mark.parametrize("graphed", [False, True])
def test_the_rollout_spans_nest_only_under_a_profiler(monkeypatch, tmp_path,
                                                      graphed):
    """Under a CPU profiler the calls record pbf.rollout with its stages
    nested inside, the capture on the first call only (the graph path with
    a stand-in graph); without a session no record_function is entered,
    and the calls are timed on the host."""
    from test_torch_ranks import _EagerGraph

    cfg, st = _dam()
    monkeypatch.setattr(tstep, "CapturedStep", _EagerGraph)
    rollout = tstep.make_rollout(cfg, "window", 1, with_stats=True,
                                 device="cpu")
    rollout.graphed = graphed
    trace = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = rollout(st)[0]
        out = rollout(out)[0]
    prof.export_chrome_trace(str(trace))
    spans = _spans(trace)
    stages = ([".zero", ".copy_in", ".replay", ".copy_out"] if graphed
              else [".replay"])
    calls = [s for s in spans if s[0] == "pbf.rollout"]
    assert len(calls) == 2
    for k, (_, a, b) in enumerate(calls):
        inside = [s[0].removeprefix("pbf.rollout") for s in spans
                  if s[0] != "pbf.rollout" and a <= s[1] and s[2] <= b]
        assert inside == ([".capture"] if graphed and k == 0 else []) + stages
    assert len(spans) == 2 + len(stages) * 2 + graphed
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _no_record_function)
    again = rollout(st)[0]
    rollout(again)
    assert rollout.stepped == 4 + graphed
    assert rollout.session.host[0] == 2


def _capture(stepper, st, with_map: bool):
    """step_into captured on the card into a kept graph: (its node counts,
    the stage map recorded, or None)."""
    static = tuple(t.clone() for t in st)
    acc = (torch.zeros((3,), dtype=torch.int32, device=st.x.device),)
    body = functools.partial(tstep.step_into, stepper)
    body(tuple(t.clone() for t in static), tuple(t.clone() for t in acc))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with cuda_pbf.captured_launches():
        with (timing.stage_map() if with_map
              else contextlib.nullcontext()) as stages:
            with torch.cuda.graph(graph):
                body(static, acc)
    counts = timing.graph_node_counts(graph.raw_cuda_graph())
    graph.reset()
    return counts, stages


@pytest.mark.card
@pytest.mark.parametrize("backend", ["window", "cell", "dense"])
def test_the_stage_map_covers_every_node_of_the_graph(card, backend):
    """On every backend the map's stages, in order, cover the captured
    graph's kernel, memset and memcpy nodes exactly, and the graph holds
    no node of another type; a Rollout's capture records the same map as
    the last one (the library that counts the nodes is loaded before)."""
    cfg, st = _dam(2048 if backend == "window" else N, card, backend)
    stepper = tstep.Stepper(cfg, backend, device=card)
    counts, stages = _capture(stepper, st, True)
    assert [s.name for s in stages] == _expected_stages(cfg, backend)
    assert counts[3] == 0
    assert sum(s.count for s in stages) == timing.device_nodes(counts)
    assert all(b.first == a.first + a.count for a, b in zip(stages,
                                                            stages[1:]))
    rollout = tstep.make_rollout(cfg, backend, 2, device=card)
    rollout(st)
    assert timing.last_stage_map() == stages
    rollout.captured.release()


@pytest.mark.card
def test_the_stage_map_adds_no_node_to_the_graph(card):
    """A capture with the stage map has the node counts of one without."""
    cfg, st = _dam(2048, card)
    stepper = tstep.Stepper(cfg, "window", device=card)
    with_map, stages = _capture(stepper, st, True)
    without, none = _capture(stepper, st, False)
    assert stages and none is None
    assert with_map == without
