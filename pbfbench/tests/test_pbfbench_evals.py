"""The reader of the density kernels' evaluated pairs (evals_per_pair) on
the synthetic traces and program of test_pbfbench_stages: a number only
from a session whose counter counted, and none from a program without it."""

import pytest

from pbfbench import harness, stages
from pbfbench.tests.test_pbfbench_stages import _ctx, _events, program  # noqa: F401


def test_evals_per_pair_reads_the_session(program, tmp_path):  # noqa: F811
    """The density kernels' evaluated pairs per solver iteration per pair
    within h; no number from a program without the counter, or whose
    counter stayed at 0 (the plain versions)."""
    ctx = _ctx(tmp_path, _events())
    read = harness.reader("evals_per_pair")
    program["value"] = {"steps": 2, "plan_candidates": 14_000}
    assert read(ctx) is None
    program["value"] |= {"pair_evals": 0}
    assert read(ctx) is None
    program["value"] |= {"pair_evals": 24_000}
    assert read(ctx) == pytest.approx(24_000 / 2 / ctx.iters / 1000)
    program["value"] |= {"steps": 3}
    assert read(ctx) is None


def test_evals_per_pair_no_number_without_the_map(monkeypatch, tmp_path):
    """Against a program with no stage map or session (an older checkout)
    the reader returns None, and does not raise."""
    monkeypatch.setattr(stages, "TRACES", tmp_path)
    monkeypatch.setattr(stages, "_timing", lambda: None)
    read = harness.reader("evals_per_pair")
    assert read(_ctx(tmp_path, _events())) is None
    none = harness.Context(n=1000, iters=3, trace=None, window_s=0.0,
                           calls_ms=[], card="cpu")
    assert read(none) is None
