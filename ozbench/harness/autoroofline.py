"""The yardstick's arithmetic of AUTO's estimator, by the rule of
``roofline.py``: each input byte read once.

AUTO estimates the mantissa loss of A by rows and of B by columns before
a product: the least it can do is read A and B once, 8 B an element, at
the HBM peak.  Its kernels are torch's (an exponent field, a group max,
a histogram of the bits each element needs), found by name, until the
program gives it a kernel of its own named ``mantissa_loss``.
"""

from __future__ import annotations

from .roofline import Product, least_s

#: the estimator's kernels by name: torch's elementwise, reduction and
#: histogram kernels, or a kernel of the program's own
ESTIMATOR_KERNELS = (r"at::native::\w*elementwise_kernel|at::native::reduce_kernel"
                     r"|kernelHistogram|mantissa_loss")


def estimator_bytes(p: Product) -> float:
    """A and B read once, 8 B an element."""
    return 8.0 * p.batch * (p.m * p.k + p.k * p.n)


def estimator_least_s(p: Product) -> float:
    return least_s(0.0, estimator_bytes(p))
