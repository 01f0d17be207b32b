"""Seconds from the start of the process to the start of the window:
imports, the device's start, the data, the problem's build, its first
solve and the traffic's warm-up requests (and on a checkout's first run
the kernels' build)."""


def read(run):
    return run.setup_s
