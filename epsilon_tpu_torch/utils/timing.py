"""Timing and profiling utilities.

Counterpart of ``epsilon_tpu/utils/timing.py``: host timers, and a trace of
everything inside a block through ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time


def wall_time_usec() -> int:
    return int(time.time() * 1e6)


def cpu_time() -> float:
    return time.process_time()


@contextlib.contextmanager
def profile_trace(log_dir: str = "epsilon_tpu_torch_trace"):
    """Capture a trace of everything inside the block (host operators, and
    the device's kernels when a CUDA device is in use):

        with profile_trace("trace_dir") as prof:
            solver.solve()

    On exit ``<log_dir>/trace.json`` holds a Chrome trace (open it at
    ``chrome://tracing`` or in Perfetto); the block's value is the
    ``torch.profiler.profile`` object, whose ``key_averages()`` are valid
    after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
