"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve", "check_on"]


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as the caller's choice.

    Raises when no GPU is visible and the caller did not ask for another
    device: the port never falls back to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA and no GPU is visible; pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise if ``t`` does not live on ``device``."""
    if t.device != device:
        raise ValueError(f"{what} lives on {t.device}, expected {device}")
