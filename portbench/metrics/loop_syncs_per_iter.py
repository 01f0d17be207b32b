"""Host calls that wait for the device inside the ADMM loop (within the
program's ``epsilon.admm_loop`` spans), an iteration of the profiled
requests."""

import bisect

from portbench.program_spans import LOOP, spans
from portbench.trace import HOST_BLOCKING


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    loops = spans(run.trace, LOOP)
    iters = sum(r.iterations for r in run.traced)
    if not loops or not iters:
        return None
    starts = [e.start for e in loops]
    inside = 0
    for e in run.trace.in_window(run.trace.host):
        if e.name in HOST_BLOCKING:
            i = bisect.bisect_right(starts, e.start) - 1
            inside += i >= 0 and e.end <= loops[i].end
    return inside / iters
