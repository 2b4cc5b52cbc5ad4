"""float64 uniform in [0, 1): ozIMMU's ``main.test`` default input."""

import torch


def make(shape, g: torch.Generator, device: torch.device) -> torch.Tensor:
    return torch.rand(shape, dtype=torch.float64, generator=g, device=device)
