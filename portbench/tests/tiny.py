"""Run the benchmark's cells at tiny sizes on the CPU, for the tests."""

from __future__ import annotations

import io
import json
import time

from portbench import harness, spec

TINY = {"tv1d_1m": {"n": 3000}, "covsel_1000": {"p": 40}}


def tiny_cell(workload):
    cell = spec.load_cell(workload)
    cell.config.update(TINY[cell.config["name"]])
    return cell


def run_tiny(workload, trace=False, seconds=1.0, seed=2**31 + 5):
    """One run of a cell at its tiny size on the CPU, as the command runs it
    but for the look for a chip.  Returns the result line's object."""
    import epsilon_tpu_torch as ep
    ep.config.set_device("cpu")
    t_start = time.perf_counter()
    result, checks = harness.run_cell(tiny_cell(workload), seed, seconds, trace, t_start,
                                      device="cpu")
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, checks, stdout=out, stderr=err)
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()
