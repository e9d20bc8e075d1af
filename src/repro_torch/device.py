"""Where the port runs: ``device=None`` means the card.

Entry points take ``device=None | str | torch.device``.  ``None`` means the
card: it resolves to ``cuda`` when a CUDA device is present and raises
otherwise — nothing carries on quietly on the CPU.  ``"cpu"`` selects the
plain versions, and only when the caller asked for it.  This module imports
nothing of the port, so every layer (`core`, `runtime`, `serve`) resolves
devices through it.
"""
from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """The default device (the card) was asked for and none is present."""


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → the card (raises without one); otherwise as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is present; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
