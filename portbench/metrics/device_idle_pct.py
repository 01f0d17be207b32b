"""The device's idle share of the profiled requests' wall time, %:
100 (1 - union of the device's busy intervals / wall)."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
