"""Device selection for the entry points."""

import torch


def require_device(device) -> torch.device:
    """The device the caller asked for. A CUDA device without a card is an
    error: nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions"
        )
    return device


def resolve_device(device) -> torch.device:
    """`device` with its index filled in: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
