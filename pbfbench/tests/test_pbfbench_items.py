"""The readers of the work-item counters (candidates_per_item,
chunk_items_max) on the synthetic traces and program of
test_pbfbench_stages: a number only from a session whose counters are
there, and none from a program without them (an older checkout, whose
session has no item counter)."""

import pytest

from pbfbench import harness, stages
from pbfbench.tests.test_pbfbench_stages import _ctx, _events, program  # noqa: F401

READERS = ("candidates_per_item", "chunk_items_max")


def test_candidates_per_item_reads_the_session(program, tmp_path):  # noqa: F811
    """The plan's (own row, candidate) pairs per work item over the
    session; no number without the item counter, or with it at 0."""
    ctx = _ctx(tmp_path, _events())
    read = harness.reader("candidates_per_item")
    assert read(ctx) is None
    program["value"] = {"steps": 2, "plan_candidates": 14_000,
                        "pair_evals": 9_000}
    assert read(ctx) is None
    program["value"] |= {"pair_items": 0}
    assert read(ctx) is None
    program["value"] |= {"pair_items": 56}
    assert read(ctx) == pytest.approx(14_000 / 56)
    program["value"] |= {"steps": 3}
    assert read(ctx) is None


def test_chunk_items_max_reads_the_session(program, tmp_path):  # noqa: F811
    """The sum of each step's most items of one chunk per step of the
    session; no number without the counter."""
    ctx = _ctx(tmp_path, _events())
    read = harness.reader("chunk_items_max")
    program["value"] = {"steps": 2, "plan_candidates": 14_000}
    assert read(ctx) is None
    program["value"] |= {"pair_items": 56, "chunk_items_max": 7}
    assert read(ctx) == pytest.approx(3.5)
    program["value"] |= {"steps": 3}
    assert read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_no_number_from_a_program_without_the_counters(monkeypatch, tmp_path,
                                                       name):
    """Against a program with no session (an older checkout) or with no
    trace the readers return None, and do not raise."""
    monkeypatch.setattr(stages, "TRACES", tmp_path)
    monkeypatch.setattr(stages, "_timing", lambda: None)
    assert harness.reader(name)(_ctx(tmp_path, _events())) is None
    none = harness.Context(n=1000, iters=3, trace=None, window_s=0.0,
                           calls_ms=[], card="cpu")
    assert harness.reader(name)(none) is None
