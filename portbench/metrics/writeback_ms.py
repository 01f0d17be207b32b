"""Host time of the write-back, ms a profiled request: the summed length of
the program's ``epsilon.write_back`` spans (the solution's copies to the
host, the variables' values and the objective)."""

from portbench.program_spans import ms_per_request


def read(run):
    return ms_per_request(run, "epsilon.write_back")
