"""Solver parameters (counterpart of ``epsilon_tpu/solvers/params.py``)."""

from __future__ import annotations

import dataclasses
import enum


class SolverKind(enum.Enum):
    PROX_ADMM = "prox_admm"
    PROX_ADMM_TWO_BLOCK = "prox_admm_two_block"


@dataclasses.dataclass
class SolverParams:
    # stopping criteria
    rel_tol: float = 1e-2
    abs_tol: float = 1e-4
    max_iterations: int = 10000
    # algorithm parameters
    rho: float = 1.0
    # over-relaxation alpha in (0, 2); only plain ADMM (1.0) is ported so far
    over_relaxation: float = 1.0
    # residual-balancing adaptive rho; not yet ported
    adaptive_rho: bool = False
    epoch_iterations: int = 10
    log_iterations: int = 100
    # compiler toggle
    use_epigraph: bool = True
    solver: SolverKind = SolverKind.PROX_ADMM_TWO_BLOCK
    warm_start: bool = False
    verbose: bool = False

    def __post_init__(self):
        if isinstance(self.solver, str):
            self.solver = SolverKind(self.solver)
        if self.adaptive_rho:
            raise NotImplementedError("adaptive rho is not yet ported")
        if self.over_relaxation != 1.0:
            raise NotImplementedError("over-relaxation is not yet ported")
        if self.solver != SolverKind.PROX_ADMM_TWO_BLOCK:
            raise NotImplementedError(
                f"the {self.solver.value} solver is not yet ported")
