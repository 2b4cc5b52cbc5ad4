"""Core enums and mode registry (a copy of ``ozimmu_tpu.types``).

Parity notes (reference: enp1s0/ozIMMU):
  - ``ComputeMode`` mirrors ``mtk::ozimmu::compute_mode_t``
    (include/ozimmu/ozimmu.hpp:14-36): ``sgemm``, ``dgemm``,
    ``fp64_int8_3`` .. ``fp64_int8_18`` and ``fp64_int8_auto``.
  - ``Operation`` mirrors ``operation_t`` (ozimmu.hpp:12).
  - ``ElementKind`` mirrors ``element_kind_t`` (ozimmu.hpp:42-45).

Modes are data (an enum plus a ``num_split`` accessor) instead of a C
switch ladder (reference src/config.cu:4-100, src/handle.cu:146-192).
"""

from __future__ import annotations

import enum
from typing import Union


class Operation(enum.Enum):
    """Transpose flag for an operand (reference ozimmu.hpp:12).

    ``C`` (conjugate transpose) EXCEEDS the reference surface: the
    reference shim silently degrades ``CUBLAS_OP_C`` to ``op_t``
    (src/cublas.cu:50-56) — wrong answers for conjugated ZGEMM through
    its LD_PRELOAD path.  Here conjugation is exact: for complex
    operands the imaginary plane's sign bits flip before the split (one
    uint32 XOR on device, ``np.conj`` on host); for real operands C is
    identical to T (conjugation is the identity).
    """

    N = "N"
    T = "T"
    C = "C"

    @classmethod
    def parse(cls, value: "OperationLike") -> "Operation":
        if isinstance(value, Operation):
            return value
        if isinstance(value, str):
            v = value.upper()
            if v in ("N", "OP_N", "NOTRANS", "NOTRANSPOSE"):
                return cls.N
            if v in ("T", "OP_T", "TRANS", "TRANSPOSE"):
                return cls.T
            if v in ("C", "OP_C", "H", "CONJTRANS", "CONJTRANSPOSE"):
                return cls.C
        raise ValueError(f"unknown operation: {value!r}")


OperationLike = Union[Operation, str]


class ElementKind(enum.Enum):
    """Real vs complex element kind (reference ozimmu.hpp:42-45)."""

    REAL = "real"
    COMPLEX = "complex"


class ComputeMode(enum.Enum):
    """Compute mode registry (reference ozimmu.hpp:14-36).

    ``FP64_INT8_<ns>`` runs the Ozaki scheme with ``ns`` int8 slices per
    operand.  ``DGEMM`` is the native-precision path (``torch.matmul`` on
    float64).  ``SGEMM`` demotes to float32.
    """

    SGEMM = "sgemm"
    DGEMM = "dgemm"
    FP64_INT8_3 = "fp64_int8_3"
    FP64_INT8_4 = "fp64_int8_4"
    FP64_INT8_5 = "fp64_int8_5"
    FP64_INT8_6 = "fp64_int8_6"
    FP64_INT8_7 = "fp64_int8_7"
    FP64_INT8_8 = "fp64_int8_8"
    FP64_INT8_9 = "fp64_int8_9"
    FP64_INT8_10 = "fp64_int8_10"
    FP64_INT8_11 = "fp64_int8_11"
    FP64_INT8_12 = "fp64_int8_12"
    FP64_INT8_13 = "fp64_int8_13"
    FP64_INT8_14 = "fp64_int8_14"
    FP64_INT8_15 = "fp64_int8_15"
    FP64_INT8_16 = "fp64_int8_16"
    FP64_INT8_17 = "fp64_int8_17"
    FP64_INT8_18 = "fp64_int8_18"
    FP64_INT8_AUTO = "fp64_int8_auto"

    @classmethod
    def parse(cls, value: "ComputeModeLike") -> "ComputeMode":
        if isinstance(value, ComputeMode):
            return value
        if isinstance(value, str):
            try:
                return cls(value.lower())
            except ValueError:
                pass
        raise ValueError(f"unknown compute mode: {value!r}")

    @classmethod
    def from_num_split(cls, ns: int) -> "ComputeMode":
        if not MIN_NUM_SPLIT <= ns <= MAX_NUM_SPLIT:
            raise ValueError(
                f"num_split must be in [{MIN_NUM_SPLIT}, {MAX_NUM_SPLIT}], got {ns}"
            )
        return cls(f"fp64_int8_{ns}")

    @property
    def is_int8(self) -> bool:
        return self.value.startswith("fp64_int8_") and self is not ComputeMode.FP64_INT8_AUTO

    @property
    def num_split(self) -> int:
        """Number of int8 slices per operand for int8 modes."""
        if not self.is_int8:
            raise ValueError(f"{self} has no num_split")
        return int(self.value.rsplit("_", 1)[1])


ComputeModeLike = Union[ComputeMode, str]

#: Slice-count bounds handled by the engine and by auto-mode selection
#: (reference split.cu:397 passes the range 3..18).
MIN_NUM_SPLIT = 3
MAX_NUM_SPLIT = 18

#: All int8 modes in ascending slice count — the candidate order used by
#: auto-mode selection (reference split.cu:473-482).
INT8_MODES = tuple(
    ComputeMode(f"fp64_int8_{ns}") for ns in range(MIN_NUM_SPLIT, MAX_NUM_SPLIT + 1)
)


def get_compute_mode_name_str(mode: ComputeModeLike) -> str:
    """Mode name string (reference handle.cu:146-192)."""
    return ComputeMode.parse(mode).value
