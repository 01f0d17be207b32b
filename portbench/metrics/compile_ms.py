"""Host time of the program's compile, ms a profiled request: the summed
length of its ``epsilon.compile`` spans (``frontend/solve.py``: the
expression problem and ``compile_problem``, fresh or for a cached
``Parameter`` re-solve)."""

from portbench.program_spans import ms_per_request


def read(run):
    return ms_per_request(run, "epsilon.compile")
