"""The device's idle share inside the ADMM loop, %: 100 (1 - the device's
busy time while the program's ``epsilon.admm_loop`` spans were under way /
those spans' length)."""

from portbench.program_spans import LOOP, spans


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    length_us = sum(e.length for e in spans(run.trace, LOOP))
    if length_us <= 0:
        return None
    busy_s, _ = run.trace.busy_during_s(LOOP)
    return 100.0 * (1.0 - busy_s * 1e6 / length_us)
