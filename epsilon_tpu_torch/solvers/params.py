"""Solver parameters (counterpart of ``epsilon_tpu/solvers/params.py``)."""

from __future__ import annotations

import dataclasses
import enum


class SolverKind(enum.Enum):
    PROX_ADMM = "prox_admm"
    PROX_ADMM_TWO_BLOCK = "prox_admm_two_block"


@dataclasses.dataclass
class SolverParams:
    """``drive`` keeps both of the JAX package's values.  The port has one
    Python epoch loop (one host sync per epoch), so ``"device"`` and
    ``"host"`` run the same code and differ only where the JAX package's
    behaviour differs for a caller: registered stop callbacks are consulted
    between epochs, and an attached checkpointer saves every
    ``every_epochs`` epochs, under ``"host"`` only; under ``"device"`` the
    solve resumes from a checkpoint at its start and saves once at its end.
    """

    # stopping criteria
    rel_tol: float = 1e-2
    abs_tol: float = 1e-4
    max_iterations: int = 10000
    # algorithm parameters
    rho: float = 1.0
    # over-relaxation alpha in (0, 2): x_hat = alpha*x + (1-alpha)*z in the
    # z/u updates (Boyd et al. sec. 3.4.3); 1.0 = plain ADMM
    over_relaxation: float = 1.0
    # residual-balancing adaptive rho (Boyd et al. sec. 3.4.1), two-block
    # solver only: rho is a 0-d tensor in the loop state and the prox applies
    # are rho-parameterized (an eigendecomposition cache instead of a
    # Cholesky factor), so a change of rho costs nothing.  rho grows by
    # rho_tau when the primal residual exceeds rho_mu times the dual
    # residual, and shrinks in the opposite case.
    adaptive_rho: bool = False
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    epoch_iterations: int = 10
    log_iterations: int = 100
    # compiler toggle
    use_epigraph: bool = True
    solver: SolverKind = SolverKind.PROX_ADMM_TWO_BLOCK
    warm_start: bool = False
    verbose: bool = False
    # 'device' or 'host': one loop in the port, see the class docstring
    drive: str = "device"
    # term sharding over several devices; None = one device
    mesh: object = None

    def __post_init__(self):
        if isinstance(self.solver, str):
            self.solver = SolverKind(self.solver)
        if self.drive not in ("device", "host"):
            raise ValueError(f"drive must be 'device' or 'host', got {self.drive!r}")
        if self.mesh is not None:
            raise NotImplementedError(
                "term sharding over a mesh is not yet ported")
