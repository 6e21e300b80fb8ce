"""Device resolution: a request for the card is met or refused, never
quietly moved to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """torch.device for `device`, with the card's index filled in; raises
    if it names CUDA and CUDA is not available."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; the port runs on the "
                         "CPU (plain torch) or on a CUDA card (its kernels)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
