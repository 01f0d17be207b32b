"""Solver status reporting (mirrors ``proto/epsilon/solver.proto``)."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class SolverState(enum.Enum):
    # solver.proto:5-13
    NOT_STARTED = "not_started"
    INITIALIZING = "initializing"
    RUNNING = "running"
    OPTIMAL = "optimal"
    MAX_ITERATIONS_REACHED = "max_iterations_reached"
    ERROR = "error"


@dataclasses.dataclass
class Residuals:
    # solver.proto:34-44
    r_norm: float = 0.0
    s_norm: float = 0.0
    epsilon_primal: float = 0.0
    epsilon_dual: float = 0.0


@dataclasses.dataclass
class Timing:
    """Host time of one solve by part, from the spans of the same names
    (``utils/timing.py``): ``init_usec`` the solver set-up this solve ran
    (0 on a cached re-solve that built nothing), ``solve_usec`` the ADMM
    loop, ``compile_usec``, ``update_usec`` (``update_problem``) and
    ``writeback_usec``; ``total_usec`` their sum."""
    # solver.proto:24-32 (populated here, unlike the reference)
    init_usec: int = 0
    solve_usec: int = 0
    total_usec: int = 0
    compile_usec: int = 0
    update_usec: int = 0
    writeback_usec: int = 0

    def add_up(self):
        self.total_usec = (self.compile_usec + self.update_usec + self.init_usec
                           + self.solve_usec + self.writeback_usec)


@dataclasses.dataclass
class SolverStatus:
    state: SolverState = SolverState.NOT_STARTED
    num_iterations: int = 0
    residuals: Residuals = dataclasses.field(default_factory=Residuals)
    timing: Timing = dataclasses.field(default_factory=Timing)
    message: str = ""
    # per-epoch residual time series (Stat/StatImpl, solver.h:22-27)
    series: Optional[List[Residuals]] = None

    def log_line(self) -> str:
        r = self.residuals
        return (f"iter={self.num_iterations} residuals "
                f"primal={r.r_norm:.2e} [{r.epsilon_primal:.2e}] "
                f"dual={r.s_norm:.2e} [{r.epsilon_dual:.2e}]")
