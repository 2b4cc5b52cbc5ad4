"""complex128 with real and imaginary parts each uniform in [0, 1):
ozIMMU's ``main.test`` urand01 input on both parts of a ZGEMM operand."""

import torch


def make(shape, g: torch.Generator, device: torch.device) -> torch.Tensor:
    re = torch.rand(shape, dtype=torch.float64, generator=g, device=device)
    im = torch.rand(shape, dtype=torch.float64, generator=g, device=device)
    return torch.complex(re, im)
