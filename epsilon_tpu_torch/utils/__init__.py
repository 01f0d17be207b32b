from .checkpoint import SolverCheckpointer  # noqa: F401
from .timing import count, counters, profile_trace, span  # noqa: F401
