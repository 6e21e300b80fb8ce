"""Device timing on the card.

Kernel launches return before the device finishes, so a host clock alone
measures the enqueue: `fence` waits for the device, and `cuda_ms` times
work with CUDA events recorded on the current stream.
"""

from __future__ import annotations

import statistics

import torch


def fence(device: torch.device | str) -> None:
    """Wait until every queued kernel on `device` has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` on the current CUDA stream, each rep
    bracketed by its own pair of events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)
