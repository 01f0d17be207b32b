from .admm import (ProxADMMSolver, ProxADMMTwoBlockSolver,  # noqa: F401
                   create_solver)
from .objective import problem_objective, term_objective  # noqa: F401
from .params import SolverKind, SolverParams  # noqa: F401
from .status import Residuals, SolverState, SolverStatus  # noqa: F401
