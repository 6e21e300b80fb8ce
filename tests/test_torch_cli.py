"""The port's runner (`python -m pdb_sph_tpu_torch.cli`) against the JAX
runner, on the CPU (`--device cpu`, n = 256)."""

import json
import os

import numpy as np
import pytest
import torch

from pdb_sph_tpu import cli as jcli
from pdb_sph_tpu_torch import cli, default_config, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.io import checkpoint

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
    cfg, state = checkpoint.load(ck)
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
    assert int(checkpoint.load(ck)[1].step) == 10


def test_nan_checkpoint_aborts_with_rc2(tmp_path):
    cfg = default_config(n=256)
    state = spawn(cfg, "standard", seed=0)
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
    checkpoint.save(ck, cfg, spawn(cfg, "standard", seed=4))
    out = {}
    for backend in ("window", "dense"):
        path = str(tmp_path / f"{backend}.npz")
        assert cli.main(["--resume", ck, "--steps", "2", "--chunk", "2",
                         "--backend", backend, "--device", "cpu",
                         "--metrics", str(tmp_path / backend),
                         "--checkpoint", path]) == 0
        _, st = checkpoint.load(path)
        out[backend] = st.x.numpy()[np.argsort(st.ids.numpy())]
    np.testing.assert_allclose(out["window"], out["dense"], rtol=1e-4,
                               atol=1e-5)
