"""One process a rank: the launcher of the sharded runs.

`run(fn, n_ranks, ...)` starts `n_ranks` processes with
`torch.multiprocessing` (start method `spawn`, so a child imports only this
package and what `fn` needs). Each joins a process group whose rendezvous
is a file store in the run's temporary directory (no TCP port, so
concurrent runs never collide), on its own device, and calls
`fn(group, device, workdir, *args)`; `workdir` is that directory, where
ranks leave what the caller reads back. A rank that raises or exits
non-zero fails the run (the others are terminated), and so does a stall:
every collective times out after `STALL_S` seconds, and once one rank has
finished, the others have `STALL_S` seconds to follow. A caller may add a
deadline for the whole run. `run` then raises, and leaves no process
behind. A rank that raises exits at once, without tearing its process
group down (its peers may be waiting in a collective with it), and leaves
its traceback for the error `run` raises. Each rank notes the stages it
passes (`note`), with their seconds, in the run's directory; a run that
stalls names each rank's last.

`rollout_ranks` is the library form of a sharded run: distribute a state
over the ranks (one card each unless the caller names other devices), roll
it out in chunks, and return after each chunk the collected state, the
chunk's stats and density diagnostics and every rank's slab bounds, with
each rank's kernel launches.
It can move the run to the compact tier between two chunks, as the JAX
package's two-tier flow does (`dryrun_multichip`, __graft_entry__.py:105-
125): collect, `ParallelConfig.compact` on the collected state,
distribute again, and one more rollout for the rest of the run.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from .. import interop
from ..config import SimConfig
from ..ops import cuda_pbf
from ..state import SimState
from .comm import Group

# seconds between checks of the ranks while waiting for them
_POLL_S = 0.2
# seconds a rank may go without progress: the limit of every collective,
# and of the ranks still running once one has finished
STALL_S = 600.0


class Chunk(NamedTuple):
    """What `rollout_ranks` returns after one chunk."""

    state: SimState       # collected, in id order, on the CPU
    stats: torch.Tensor   # (D, 5), ShardedRollout's aggregate
    diag: torch.Tensor    # (D, 3)
    secs: float           # rank 0's seconds for the chunk, fenced
    density: torch.Tensor  # (D, 5), the sharded density diagnostics
    bounds: torch.Tensor  # (D, D + 2), every rank's bounds row


class RankFailure(RuntimeError):
    """A rank raised, exited non-zero, or outlived the run's time limit."""


# when this rank process started, for the seconds of its notes
_T0 = time.monotonic()


def note(workdir: str, rank: int, what: str) -> None:
    """Append `what`, with this rank's seconds since it started, to
    notes{rank}.txt in the run's directory."""
    with open(os.path.join(workdir, f"notes{rank}.txt"), "a") as f:
        f.write(f"{time.monotonic() - _T0:.2f} s {what}\n")


def _last_notes(workdir: str, n_ranks: int) -> str:
    last = []
    for r in range(n_ranks):
        try:
            with open(os.path.join(workdir, f"notes{r}.txt")) as f:
                last.append(f"rank {r}: {f.read().splitlines()[-1]}")
        except (OSError, IndexError):
            last.append(f"rank {r}: no note")
    return "; ".join(last)


def _rank_entry(rank: int, n_ranks: int, workdir: str, comm: str,
                devices: Sequence[str], threads: int, timeout_s: float,
                fn: Callable, args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    group = Group.init(rank, n_ranks,
                       "file://" + os.path.join(workdir, "store"), comm,
                       timeout_s=timeout_s)
    note(workdir, rank, "joined the group")
    try:
        fn(group, device, workdir, *args)
    except Exception:
        # leave at once: a group torn down while a peer waits in one of its
        # collectives, or while a graph holds captured collectives of it,
        # can wait as long as the peer does
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        note(workdir, rank, "raised")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    note(workdir, rank, "returned")
    gc.collect()   # whatever still holds a graph goes before the group
    group.close()
    note(workdir, rank, "closed the group")


def _stop(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    for p in ctx.processes:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run(fn: Callable, n_ranks: int, devices: Sequence[str],
        comm: str | None = None, timeout_s: float | None = None,
        workdir: str | None = None, args: tuple = ()) -> None:
    """Run `fn(group, device, workdir, *args)` on `n_ranks` processes,
    rank r on `devices[r]` ("cpu", "cuda:0", ...), with the collective
    backend `comm` (default: NCCL for cards, gloo for the CPU; gloo with
    card tensors stages them through pinned host memory). `fn` must be a
    module-level function of an importable module. Raises RankFailure when
    a rank fails, stalls (see `STALL_S`) or the run outlives `timeout_s`
    (no deadline when None). `workdir` (a fresh temporary directory when
    None, removed afterwards) holds the rendezvous file and whatever the
    ranks write."""
    if len(devices) != n_ranks:
        raise ValueError(f"{n_ranks} ranks need {n_ranks} devices, got "
                         f"{list(devices)}")
    if comm is None:
        comm = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pbf_ranks_")
    threads = max(1, torch.get_num_threads() // n_ranks)
    limit = min(STALL_S, timeout_s or STALL_S)
    ctx = mp.start_processes(
        _rank_entry, args=(n_ranks, workdir, comm, list(devices), threads,
                           limit, fn, args),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = None if not timeout_s else time.monotonic() + timeout_s
    first_done = None
    try:
        while True:
            try:
                if ctx.join(timeout=_POLL_S):
                    return
            except ProcessException as e:
                try:
                    with open(os.path.join(
                            workdir, f"error{e.error_index}.txt")) as f:
                        why = f.read()
                except OSError:
                    why = str(e)
                raise RankFailure(f"rank {e.error_index} failed: {why}") \
                    from e
            now = time.monotonic()
            if deadline is not None and now > deadline:
                raise RankFailure(f"the {n_ranks} ranks outlived their "
                                  f"time limit of {timeout_s} s; last "
                                  f"notes: {_last_notes(workdir, n_ranks)}")
            if first_done is None and any(p.exitcode == 0
                                          for p in ctx.processes):
                first_done = now
            if first_done is not None and now - first_done > STALL_S:
                raise RankFailure(f"a rank was still running {STALL_S} s "
                                  "after another had finished; last notes: "
                                  f"{_last_notes(workdir, n_ranks)}")
    finally:
        _stop(ctx)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def _rollout_rank(group: Group, device: torch.device, workdir: str,
                  cfg: SimConfig, arrays: tuple, chunks: Sequence[int],
                  backend: str, pcfg, retier: int | None = None):
    """A rank of `rollout_ranks`. Returns the last tier's rollout, not
    released, and the state its last chunk left, so that a rank function
    built on this one can go on from them."""
    from ..utils.timing import fence
    from .sharded import ParallelConfig, collect, distribute, tier_programs

    state = interop.state_from_numpy(*arrays, 0, "cpu")
    pcfg = pcfg or ParallelConfig.create(cfg, group.size, state=state)
    sst = distribute(cfg, pcfg, state, group, device)
    # one rollout a tier: every chunk replays its stepper, scratch and (on
    # NCCL ranks) graph
    rollout, density_diag = tier_programs(cfg, pcfg, group, backend,
                                          chunks[0], device)
    cuda_pbf.reset_launches()
    out = {}
    for i, steps in enumerate(chunks):
        if i == retier:
            # the compact tier, sized from the state the last chunk left;
            # the spawn tier's graph, buffers and scratch go first
            rollout.release()
            rollout = density_diag = sst = None
            pcfg = ParallelConfig.compact(cfg, group.size, state=st,
                                          prior=pcfg)
            sst = distribute(cfg, pcfg, st, group, device)
            rollout, density_diag = tier_programs(cfg, pcfg, group, backend,
                                                  chunks[0], device)
            note(workdir, group.rank, f"re-tiered before chunk {i}")
        fence(device)
        t0 = time.perf_counter()
        sst, stats, diag = rollout(sst, steps)
        fence(device)
        secs = torch.tensor(time.perf_counter() - t0, dtype=torch.float64)
        st = collect(sst, group)
        out.update({f"x{i}": st.x, f"v{i}": st.v, f"ids{i}": st.ids,
                    f"stats{i}": stats, f"diag{i}": diag,
                    f"density{i}": density_diag(sst), f"secs{i}": secs,
                    f"bounds{i}": group.all_gather(sst.bounds)})
        note(workdir, group.rank, f"chunk {i} ({steps} steps) in "
                                  f"{float(secs):.3f} s")
    with open(os.path.join(workdir, f"launches{group.rank}.json"), "w") as f:
        json.dump(cuda_pbf.LAUNCHES, f)
    if group.rank == 0:
        np.savez(os.path.join(workdir, "result.npz"),
                 **{k: t.cpu().numpy() for k, t in out.items()})
    return rollout, sst


def rollout_ranks(cfg: SimConfig, state: SimState, n_ranks: int,
                  chunks: Sequence[int], backend: str = "window",
                  devices: Sequence[str] | None = None,
                  comm: str | None = None, pcfg=None,
                  timeout_s: float | None = None,
                  retier: int | None = None):
    """Roll `state` out on `n_ranks` ranks, rank r on `devices[r]`
    (default: card r, which needs `n_ranks` cards; `["cpu"] * n_ranks` for
    CPU ranks), in chunks of `chunks[i]` steps, from
    `ParallelConfig.create(cfg, n_ranks, state=state)` unless `pcfg` is
    given. With `retier` = i (0 < i < len(chunks)), chunk i and those after
    it run on the compact tier: `ParallelConfig.compact(cfg, n_ranks,
    state=<the state after chunk i - 1>, prior=pcfg)`. Returns ([a `Chunk`
    after each chunk], [each rank's kernel launch counts, the diagnostics'
    included])."""
    if devices is None:
        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(
                f"{n_ranks} ranks need {n_ranks} cards, torch sees "
                f"{torch.cuda.device_count()}; pass devices=['cpu'] * "
                f"{n_ranks} to run them on the CPU")
        devices = [f"cuda:{r}" for r in range(n_ranks)]
    devices = list(devices)
    if retier is not None and not 0 < retier < len(chunks):
        raise ValueError(f"retier must name a chunk after the first of "
                         f"{len(chunks)}, got {retier}")
    arrays = tuple(t.detach().cpu().numpy() for t in state[:3])
    with tempfile.TemporaryDirectory(prefix="pbf_ranks_") as workdir:
        run(_rollout_rank, n_ranks, devices, comm, timeout_s, workdir,
            args=(cfg, arrays, list(chunks), backend, pcfg, retier))
        return read_chunks(workdir, n_ranks, len(chunks))


def read_chunks(workdir: str, n_ranks: int, n_chunks: int):
    """What `_rollout_rank`'s ranks left in `workdir`: ([a `Chunk` after
    each chunk], [each rank's kernel launch counts])."""
    with np.load(os.path.join(workdir, "result.npz")) as z:
        res = {k: z[k] for k in z.files}
    launches = []
    for r in range(n_ranks):
        with open(os.path.join(workdir, f"launches{r}.json")) as f:
            launches.append(json.load(f))
    out = []
    for i in range(n_chunks):
        st = interop.state_from_numpy(res[f"x{i}"], res[f"v{i}"],
                                      res[f"ids{i}"], 0, "cpu")
        out.append(Chunk(st, torch.from_numpy(res[f"stats{i}"]),
                         torch.from_numpy(res[f"diag{i}"]),
                         float(res[f"secs{i}"]),
                         torch.from_numpy(res[f"density{i}"]),
                         torch.from_numpy(res[f"bounds{i}"])))
    return out, launches
