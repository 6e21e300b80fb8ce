"""run.py without a card, and in a checkout without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from pbfbench import harness

ARGS = ["--workload", "dam80k.frames", "--seed", str(2 ** 31 + 7),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "pbfbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = _run(harness.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "pbfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, {**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    r = _run(harness.ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
