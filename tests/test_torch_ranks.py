"""The multi-rank sharded rollout of the port on gloo ranks on the CPU.

On a card, NCCL ranks run the sharded step as a CUDA graph whose body is
`sharded.step_into`; here that body runs eagerly in D = 2 and D = 4 gloo
ranks, through the rollout's graph path with a stand-in for the graph,
against the eager ShardedStepper loop, partial chunks included. Also: a
multi-rank step builds no tensor from host values, the collectives give
what the old forms gave, `rollout_ranks` builds one stepper a rank, the
rollout's choice of graph follows the group's backend, and the one-rank
body a card captures is the eager loop on either backend.

A spawned rank imports this module to find its rank function, but no patch
made here reaches it: each rank function makes its own.
"""

import json
import multiprocessing
import os
import types

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from pdb_sph_tpu_torch import default_config, interop, spawn
from pdb_sph_tpu_torch.core import step as tstep
from pdb_sph_tpu_torch.parallel import launch, sharded
from pdb_sph_tpu_torch.parallel.comm import Group

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120.0


def _cfg():
    # capacity 16 holds the densest cell of the 1024 dam break (cell)
    return default_config(n=1024, cell_capacity=16, block=16,
                          max_occupied_cells=1024)


def _arrays(cfg):
    st = spawn(cfg, "dam_break", seed=0, device="cpu")
    return tuple(t.numpy() for t in st[:3])


def _rank_state(group, device, cfg, arrays):
    state = interop.state_from_numpy(*arrays, 0, "cpu")
    pcfg = sharded.ParallelConfig.create(cfg, group.size, state=state)
    return pcfg, sharded.distribute(cfg, pcfg, state, group, device)


def _write(workdir, rank, result) -> None:
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _run(fn, D, tmp_path, *args):
    """fn on D gloo ranks on the CPU; each rank's JSON result."""
    launch.run(fn, D, ["cpu"] * D, timeout_s=RANK_TIMEOUT_S,
               workdir=str(tmp_path), args=args)
    assert not multiprocessing.active_children()
    out = []
    for r in range(D):
        with open(tmp_path / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


class _EagerGraph(tstep.CapturedStep):
    """CapturedStep as a card builds it (the eager warm-up step on copies,
    the static state and accumulators), with a graph whose replay runs the
    body eagerly: the rollout's graph path on the CPU."""

    def __init__(self, body, state, acc):
        body(tuple(t.clone() for t in state), tuple(t.clone() for t in acc))
        self.state = tuple(t.clone() for t in state)
        self.acc = tuple(t.clone() for t in acc)
        self.launches = {}
        self.graph = types.SimpleNamespace(
            replay=lambda: body(self.state, self.acc))


def _equal(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b))


def _body_rank(group, device, workdir, cfg, arrays, backend, chunks):
    """The graph path of one rollout over `chunks` against the eager
    ShardedStepper loop over the same steps, chunk by chunk."""
    pcfg, sst = _rank_state(group, device, cfg, arrays)
    sharded.CapturedStep = _EagerGraph
    roll = sharded.make_sharded_rollout(cfg, pcfg, group, backend,
                                        chunks[0], device)
    eager_loop = not roll.graphed
    roll.graphed = True
    eager = sharded.ShardedStepper(cfg, pcfg, group, backend, device)
    got, want = sst, sst
    result = {"eager_loop_on_gloo": eager_loop, "chunks": []}
    captured = None
    for steps in chunks:
        got, stats, diag = roll(got, steps)
        captured = captured or roll.captured
        acc = (torch.zeros((5,), dtype=torch.int32),
               torch.zeros((3,), dtype=torch.float32))
        for _ in range(steps):
            want, s, d = eager.step(want)
            sharded._aggregate(acc, s, d)
        w_stats, w_diag = eager.gather(*acc)
        result["chunks"].append({
            "state": _equal(got, want), "stats": torch.equal(stats, w_stats),
            "diag": torch.equal(diag, w_diag), "active": stats[:, 0].tolist(),
            "overflow": int(stats[:, 1:].sum())})
    result["one_capture"] = roll.captured is captured
    _write(workdir, group.rank, result)


@pytest.mark.parametrize("backend", ["window", "cell"])
@pytest.mark.parametrize("D", [2, 4])
def test_the_captured_body_on_gloo_ranks_is_the_eager_loop(tmp_path, D,
                                                           backend):
    cfg = _cfg()
    chunks = [3, 2]
    for r in _run(_body_rank, D, tmp_path, cfg, _arrays(cfg), backend,
                  chunks):
        assert r["eager_loop_on_gloo"] and r["one_capture"]
        for c in r["chunks"]:
            assert c["state"] and c["stats"] and c["diag"], c
            assert sum(c["active"]) == cfg.n and c["overflow"] == 0


class _NoHostValues(TorchDispatchMode):
    """Raise at every tensor made from Python data (`aten.lift_fresh`):
    `torch.tensor`, and an index given as a list."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            raise AssertionError("a step built a tensor from host values")
        return func(*args, **(kwargs or {}))


def _host_tensor_rank(group, device, workdir, cfg, arrays, backend):
    pcfg, sst = _rank_state(group, device, cfg, arrays)
    stepper = sharded.ShardedStepper(cfg, pcfg, group, backend, device)
    with _NoHostValues():
        out, stats, _ = stepper.step(sst)
        gathered, _ = stepper.gather(stats, stats.float())
    _write(workdir, group.rank, {"active": int(gathered[:, 0].sum()),
                                 "overflow": int(gathered[:, 1:].sum()),
                                 "step": int(out.bounds[0])})


@pytest.mark.parametrize("backend", ["window", "cell"])
def test_a_multi_rank_step_builds_no_tensor_from_host_values(tmp_path,
                                                             backend):
    """On a card such a tensor is a copy from the host that waits for the
    queued work, and a CUDA graph cannot capture one: the constants of
    every rank's step are made when its stepper is built."""
    cfg = _cfg()
    for r in _run(_host_tensor_rank, 2, tmp_path, cfg, _arrays(cfg),
                  backend):
        assert r == {"active": cfg.n, "overflow": 0, "step": 1}


def _forms_rank(group, device, workdir):
    """Group.all_gather and shift against the forms they replaced: a list
    all_gather stacked, and the shifts read off the gathered rows."""
    r, D = group.rank, group.size
    gen = torch.Generator().manual_seed(r)
    cases = [torch.randn((7, 4), generator=gen),
             torch.randint(-9, 9, (5,), generator=gen, dtype=torch.int32),
             torch.randn((3,), generator=gen)]
    same = []
    for t in cases:
        parts = [torch.zeros_like(t) for _ in range(D)]
        dist.all_gather(parts, t)
        rows = torch.stack(parts)
        same.append(torch.equal(group.all_gather(t), rows))
        for d in (1, -1):
            src = r - d
            want = rows[src] if 0 <= src < D else torch.zeros_like(t)
            same.append(torch.equal(group.shift(t, d), want))
    _write(workdir, r, {"same": same})


@pytest.mark.parametrize("D", [2, 4])
def test_the_collectives_give_what_the_old_forms_gave(tmp_path, D):
    """One buffer for all_gather; shift delivers rank - direction's tensor
    and zeros on the edge rank, bit for bit."""
    for r in _run(_forms_rank, D, tmp_path):
        assert all(r["same"]) and len(r["same"]) == 9


def _count_steppers_rank(group, device, workdir, *args):
    built = []
    init = sharded.ShardedStepper.__init__

    def counting(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    sharded.ShardedStepper.__init__ = counting
    launch._rollout_rank(group, device, workdir, *args)
    _write(workdir, group.rank, {"steppers": len(built)})


def test_rollout_ranks_builds_one_stepper_a_rank(tmp_path):
    """Chunks of 2, 2 and 1 steps all run on the rollout built first, whose
    scratch the diagnostics share."""
    cfg = _cfg()
    for r in _run(_count_steppers_rank, 2, tmp_path, cfg, _arrays(cfg),
                  [2, 2, 1], "window", None):
        assert r["steppers"] == 1
    assert (tmp_path / "result.npz").exists()


def test_the_rollout_is_a_graph_on_nccl_ranks_only():
    """On a card: one rank (no group) and NCCL ranks, on either backend."""
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    nccl, gloo = Group(0, 2, "nccl"), Group(0, 2, "gloo")
    assert sharded.captures(card, nccl) and sharded.captures(card, None)
    assert not sharded.captures(card, gloo)
    assert not sharded.captures(cpu, nccl) and not sharded.captures(cpu, None)


@pytest.mark.parametrize("backend", ["window", "cell"])
def test_the_one_rank_captured_body_is_the_eager_loop(monkeypatch, backend):
    """The body a one-rank rollout captures on a card, on either backend,
    through the graph path with the stand-in graph: the eager loop's bits
    over a chunk and a partial chunk, and no tensor made from host values
    (which a capture refuses)."""
    cfg = _cfg()
    state = spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=state)
    sst = sharded.distribute(cfg, pcfg, state, device="cpu")
    monkeypatch.setattr(sharded, "CapturedStep", _EagerGraph)
    roll = sharded.make_sharded_rollout(cfg, pcfg, None, backend, 3, "cpu")
    assert not roll.graphed
    roll.graphed = True
    eager = sharded.ShardedStepper(cfg, pcfg, None, backend, "cpu")
    got = want = sst
    for steps in (3, 2):
        with _NoHostValues():
            got, stats, diag = roll(got, steps)
        acc = (torch.zeros((5,), dtype=torch.int32),
               torch.zeros((3,), dtype=torch.float32))
        for _ in range(steps):
            want, s, d = eager.step(want)
            sharded._aggregate(acc, s, d)
        w_stats, w_diag = eager.gather(*acc)
        assert _equal(got, want)
        assert torch.equal(stats, w_stats) and torch.equal(diag, w_diag)
        assert stats.tolist() == [[cfg.n, 0, 0, 0, 0]]
