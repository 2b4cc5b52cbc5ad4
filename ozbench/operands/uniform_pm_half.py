"""float64 uniform in [-0.5, 0.5): HPL's own generator (``HPL_pdmatgen``)."""

import torch


def make(shape, g: torch.Generator, device: torch.device) -> torch.Tensor:
    return torch.rand(shape, dtype=torch.float64, generator=g, device=device).sub_(0.5)
