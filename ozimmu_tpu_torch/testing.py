"""Test/benchmark input generators and error metrics (numpy only).

A copy of the numpy part of ``ozimmu_tpu.testing``, so that a run on the
GPU machine has an oracle without importing the JAX package:
  - input distributions ``urand01`` / ``normal01`` / ``exp_rand-<phi>``
    (reference test/main_test.cu:56-80, 195-232).  ``exp_rand`` draws
    ``(u - 0.5) * exp(phi * randn)`` to generate wide exponent spread.
  - error metrics ``relative_residual`` and ``max_relative_error`` against
    a higher-precision reference GEMM (reference test/mateval usage at
    test/main_test.cu:101-117).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate_input(
    name: str, shape, seed: int = 0, complex_: bool = False
) -> np.ndarray:
    """Generate a test matrix per the named distribution."""

    def gen(sd):
        r = np.random.default_rng(sd)
        if name == "urand01":
            return r.uniform(0.0, 1.0, size=shape)
        if name == "normal01":
            return r.normal(0.0, 1.0, size=shape)
        if name.startswith("exp_rand"):
            phi = float(name.split("-", 1)[1]) if "-" in name else 1.0
            u = r.uniform(0.0, 1.0, size=shape)
            g = r.normal(0.0, 1.0, size=shape)
            return (u - 0.5) * np.exp(phi * g)
        raise ValueError(f"unknown input distribution: {name!r}")

    if complex_:
        return gen(seed) + 1j * gen(seed + 10**6)
    return gen(seed)


def reference_gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Higher-precision reference product (mateval equivalent).

    Uses longdouble (80-bit extended on x86) accumulation.
    """
    return (a.astype(np.clongdouble) if np.iscomplexobj(a) else a.astype(np.longdouble)) @ (
        b.astype(np.clongdouble) if np.iscomplexobj(b) else b.astype(np.longdouble)
    )


def error_metrics(
    c: np.ndarray, a: np.ndarray, b: np.ndarray, c_ref=None
) -> Dict[str, float]:
    """relative_residual and max_relative_error vs a higher-precision ref
    (reference test/main_test.cu:101-117); ``c_ref`` defaults to
    :func:`reference_gemm` of ``a`` and ``b``."""
    if c_ref is None:
        c_ref = reference_gemm(a, b)
    diff = c.astype(c_ref.dtype) - c_ref
    denom = np.linalg.norm(c_ref.astype(np.complex128 if np.iscomplexobj(c_ref) else np.float64))
    residual = float(
        np.linalg.norm(diff.astype(np.complex128 if np.iscomplexobj(diff) else np.float64)) / denom
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(diff) / np.abs(c_ref)
        rel = np.where(np.abs(c_ref) == 0, 0.0, rel)
    return {
        "relative_residual": residual,
        "max_relative_error": float(np.max(rel)),
    }
