"""The process group of the sharded step: the port's counterpart of the JAX
mesh (`make_mesh`, `jax.lax.all_gather` and `jax.lax.ppermute` in
pdb_sph_tpu/parallel/sharded.py).

A `Group` holds one rank's view of a 1-D chain of ranks, rank r owning slab
r. It offers the two collectives the decomposition needs: `all_gather` of a
fixed-shape tensor, and `shift`, the neighbour exchange of `pshift`
(sharded.py:768-770): every rank sends to rank + direction, and an edge
rank, which has no sender on that side, receives zeros.

It runs on `torch.distributed`: NCCL with one rank per card, gloo on the
CPU. gloo moves host memory only, so a gloo group whose tensors live on a
card (several ranks sharing one card, which NCCL refuses) copies each
message through a pinned host buffer and back, and waits for the card
each time. On NCCL neither collective reads anything back to the host, so
a CUDA graph takes them in with the step. A one-rank run has no group at
all: the sharded step takes its fast path.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


class Group:
    """One rank of an initialised process group."""

    def __init__(self, rank: int, size: int, backend: str):
        self.rank = rank
        self.size = size
        self.backend = backend

    @classmethod
    def init(cls, rank: int, size: int, init_method: str, backend: str,
             timeout_s: float = 1800.0) -> "Group":
        """Join the group of `size` ranks at `init_method` (a `file://`
        store of the run's temporary directory, or `tcp://host:port`).
        `timeout_s` bounds every collective."""
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
        return cls(rank, size, backend)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend sends: `t`, or for gloo and a card
        tensor a pinned host copy, complete before it is sent."""
        t = t.contiguous()
        if self.backend != "gloo" or t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host

    @staticmethod
    def _wire_like(send: torch.Tensor, rows: int) -> torch.Tensor:
        """A zeroed receive buffer of `rows` rows of messages like the wire
        tensor `send`, pinned where `send` is."""
        return torch.zeros((rows, *send.shape[1:]), dtype=send.dtype,
                           device=send.device, pin_memory=send.is_pinned())

    @staticmethod
    def _home(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return wire.to(like.device, non_blocking=True)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's `t` (at least one dimension), in
        rank order, gathered by one collective into one buffer allocated
        here (inside a CUDA graph, from the graph's pool, at an address
        every replay keeps)."""
        send = self._wire(t)
        out = self._wire_like(send, self.size * send.shape[0])
        dist.all_gather_into_tensor(out, send)
        return self._home(out.view(self.size, *send.shape), t)

    def shift(self, t: torch.Tensor, direction: int) -> torch.Tensor:
        """Send `t` to rank + direction (+1 or -1) and return what rank -
        direction sent; zeros on the rank that has no such neighbour."""
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        send = self._wire(t)
        recv = self._wire_like(send, send.shape[0])
        dst, src = self.rank + direction, self.rank - direction
        ops = []
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, send, dst))
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return self._home(recv, t)
