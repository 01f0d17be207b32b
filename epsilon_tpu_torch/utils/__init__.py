from .checkpoint import SolverCheckpointer  # noqa: F401
from .timing import cpu_time, profile_trace, wall_time_usec  # noqa: F401
