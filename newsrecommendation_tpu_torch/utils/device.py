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


def to_device(params, device):
    """A nested dict of tensors with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)
