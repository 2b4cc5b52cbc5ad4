"""float64 ``(u - 0.5)·exp(2·z)``, u uniform in [0, 1) and z standard
normal: ozIMMU's ``main.test`` ``exp_rand-2`` input (φ = 2), whose
magnitudes span many binades."""

import torch

PHI = 2.0


def make(shape, g: torch.Generator, device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, dtype=torch.float64, generator=g, device=device)
    z = torch.randn(shape, dtype=torch.float64, generator=g, device=device)
    return z.mul_(PHI).exp_().mul_(u.sub_(0.5))
