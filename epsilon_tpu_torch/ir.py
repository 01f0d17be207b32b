"""Prox-affine intermediate representation.

TPU-native replacement for the reference's protobuf IR
(``proto/epsilon/expression.proto``): instead of serialized protos crossing a
C++ boundary, the compiled problem is a host-side Python structure holding
structured linear operators (:mod:`epsilon_tpu_torch.ops.linop`) and concrete
constants; the solver applies it with PyTorch tensors.

The semantic contract is the same prox-affine form the reference compiles to:

    minimize    sum_i alpha_i * f_i(H_i(x_i))
    subject to  sum_i A_i(x_i) = b        (ZERO cone constraints)

where every f_i is one of ~30 :class:`ProxKind` functions with a fast
proximal operator (``expression.proto:122-197``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .ops.block import BlockMatrix, BlockVector


class ProxKind(enum.Enum):
    """Mirrors ``ProxFunction::Type`` (``expression.proto:122-167``)."""

    # Simple
    AFFINE = "affine"
    CONSTANT = "constant"
    # Affine family
    ZERO = "zero"
    SUM_SQUARE = "sum_square"
    # Elementwise
    NON_NEGATIVE = "non_negative"
    NORM_1 = "norm_1"
    SUM_DEADZONE = "sum_deadzone"
    SUM_EXP = "sum_exp"
    SUM_HINGE = "sum_hinge"
    SUM_INV_POS = "sum_inv_pos"
    SUM_KL_DIV = "sum_kl_div"
    SUM_LOGISTIC = "sum_logistic"
    SUM_NEG_ENTR = "sum_neg_entr"
    SUM_NEG_LOG = "sum_neg_log"
    SUM_QUAD_OVER_LIN = "sum_quad_over_lin"
    SUM_QUANTILE = "sum_quantile"
    EXP = "exp"
    # Vector
    LOG_SUM_EXP = "log_sum_exp"
    MAX = "max"
    NORM_2 = "norm_2"
    NORM_INF = "norm_inf"
    SECOND_ORDER_CONE = "second_order_cone"
    SUM_LARGEST = "sum_largest"
    TOTAL_VARIATION_1D = "total_variation_1d"
    # Matrix
    LAMBDA_MAX = "lambda_max"
    MATRIX_FRAC = "matrix_frac"
    NEG_LOG_DET = "neg_log_det"
    NORM_NUCLEAR = "norm_nuclear"
    SEMIDEFINITE = "semidefinite"
    SIGMA_MAX = "sigma_max"


class Cone(enum.Enum):
    """Mirrors ``Cone::Type`` (``expression.proto:81-92``)."""

    ZERO = "zero"
    NON_NEGATIVE = "non_negative"
    SECOND_ORDER = "second_order"
    EXPONENTIAL = "exponential"
    SEMIDEFINITE = "semidefinite"


@dataclasses.dataclass
class ProxFunctionSpec:
    """Parameters of one prox term (``ProxFunction`` message,
    ``expression.proto:122-197``)."""

    kind: ProxKind
    epigraph: bool = False
    alpha: float = 1.0
    # Shapes of each argument, e.g. [(m, n)] — needed for matrix-valued
    # functions operating on mat(x_i) and for axis-mode batching.
    arg_sizes: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    # SUM_LARGEST
    k: Optional[int] = None
    # SUM_DEADZONE margin / SUM_QUANTILE weights
    scaled_zone_params: Optional[Dict[str, Any]] = None
    # Axis-mode: apply the vector kernel along rows/cols of a matrix arg
    axis: Optional[int] = None

    def __repr__(self):
        bits = [self.kind.value]
        if self.epigraph:
            bits.append("epigraph")
        if self.alpha != 1.0:
            bits.append(f"alpha={self.alpha}")
        if self.k is not None:
            bits.append(f"k={self.k}")
        if self.axis is not None:
            bits.append(f"axis={self.axis}")
        return f"ProxFunctionSpec({', '.join(bits)})"


@dataclasses.dataclass
class AffineOperator:
    """(A, b) pair: x -> A x + b over block keys (``affine/affine.h:20-25``)."""

    A: BlockMatrix
    b: BlockVector

    @classmethod
    def empty(cls) -> "AffineOperator":
        return cls(BlockMatrix(), BlockVector())


@dataclasses.dataclass
class ProxTerm:
    """One term alpha*f(H(x)) in the prox-affine objective.

    ``H`` maps solver variables (column keys = variable ids) to the
    function's argument space (row keys = ``arg:<i>``), mirroring
    ``prox_admm.cc:45-94``.
    """

    spec: ProxFunctionSpec
    H: AffineOperator


@dataclasses.dataclass
class ConeConstraint:
    """An indicator constraint: A x + b in K."""

    cone: Cone
    op: AffineOperator


@dataclasses.dataclass
class ProxProblem:
    """The compiled prox-affine problem (``Problem`` message,
    ``expression.proto:339-346``, post-compilation invariants per
    ``compiler/validate.py``)."""

    terms: List[ProxTerm]
    constraints: List[ConeConstraint]
    # variable id -> flattened dimension
    var_dims: Dict[str, int]
    # variable id -> original (m, n) shape for un-vectorizing solutions
    var_shapes: Dict[str, Tuple[int, ...]]

    def __repr__(self):
        lines = ["ProxProblem("]
        for t in self.terms:
            keys = sorted({c for (_, c) in t.H.A.blocks})
            lines.append(f"  {t.spec!r} over {keys}")
        for c in self.constraints:
            keys = sorted({cc for (_, cc) in c.op.A.blocks})
            lines.append(f"  s.t. {c.cone.value}({keys})")
        lines.append(")")
        return "\n".join(lines)


def arg_key(i: int) -> str:
    """Row key for the i-th prox argument (``affine.cc:131-134``)."""
    return f"arg:{i}"


def constraint_key(i: int) -> str:
    """Row key for the i-th constraint (``affine.cc:136-140``)."""
    return f"constraint:{i}"
