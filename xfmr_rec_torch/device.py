"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The port targets the card: asking for CUDA where no card is visible
    raises instead of quietly running the plain CPU versions. Callers that
    mean the CPU (the parity tests) pass ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
        raise RuntimeError(msg)
    return dev
