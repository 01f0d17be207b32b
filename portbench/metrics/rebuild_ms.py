"""Host time of a cached solver's rebuild for new ``Parameter`` values, ms
a profiled request: the summed length of the program's
``epsilon.update_problem`` spans (``solvers/admm.py`` ``update_problem``)."""

from portbench.program_spans import ms_per_request


def read(run):
    return ms_per_request(run, "epsilon.update_problem")
