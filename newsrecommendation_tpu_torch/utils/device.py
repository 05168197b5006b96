"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is missing:
a run that asked for the card never carries on quietly on the CPU. Callers
that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def rank_device(device="cuda", local_rank: int = 0,
                backend=None) -> torch.device:
    """The device of one rank: "cuda" without an index is
    ``cuda:{local_rank}``; an explicit index is kept (two gloo ranks may
    share a card). Under NCCL a rank past the cards raises, since NCCL
    refuses two ranks on one card; the rank's card becomes the current
    one, where NCCL's collectives run."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        if backend == "nccl" and local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own: "
                f"{torch.cuda.device_count()} cards, and NCCL takes one "
                "rank per card")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def to_device(params, device):
    """A nested dict of tensors with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)
