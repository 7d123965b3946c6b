"""Device resolution: the port computes where it is told to, or raises."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Asking for CUDA without a card
    raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU), so a host clock read after it times the work and not its
    enqueueing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
