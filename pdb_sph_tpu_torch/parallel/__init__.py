"""Multi-device decomposition of the port: `sharded` (the step, rollout and
diagnostics of one rank), `comm` (the process group), `launch` (one process
a rank), `soak` (the invariants of a long run)."""

from .comm import Group
from .sharded import (
    ParallelConfig,
    ShardedState,
    collect,
    distribute,
    initial_bounds,
    make_sharded_diagnostics,
    make_sharded_rollout,
    make_sharded_step,
)

__all__ = [
    "Group",
    "ParallelConfig",
    "ShardedState",
    "collect",
    "distribute",
    "initial_bounds",
    "make_sharded_diagnostics",
    "make_sharded_rollout",
    "make_sharded_step",
]
