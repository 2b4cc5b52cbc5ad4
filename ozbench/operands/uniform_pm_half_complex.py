"""complex128 with real and imaginary parts each uniform in [-0.5, 0.5):
HPL's own generator (``HPL_pdmatgen``) on both parts, made in place (a
complex ``torch.rand`` draws each part as a float64 uniform in [0, 1))."""

import torch


def make(shape, g: torch.Generator, device: torch.device) -> torch.Tensor:
    return torch.rand(shape, dtype=torch.complex128, generator=g, device=device).sub_(0.5 + 0.5j)
