"""What the request kinds share: the order in which they visit the
instances, the record of one request, and one timed solve."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


def instance_order(order: str, count: int, call: int) -> int:
    """The instance of the ``call``-th solve (the set-up's included):
    ``cycle`` runs 0, 1, ..., count-1, 0, ..."""
    if order == "cycle":
        return call % count
    raise ValueError(f"unknown order {order!r}")


@dataclass
class Request:
    index: int
    instance: int
    t0: float                  # host clock when the data is handed over
    t1: float = 0.0            # host clock when solve has returned the values
    iterations: int = 0
    solve_usec: int = 0        # the program's own timers (SolverStatus.timing)
    init_usec: int = 0
    ok: bool = False           # the solve returned and reports "optimal"
    error: str = ""
    answer: Optional[np.ndarray] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def no_span(name):
    return contextlib.nullcontext()


def finish(req: Request, prob, family, variable, sync) -> Request:
    """Fill in a request once ``solve`` has returned."""
    sync()
    req.t1 = time.perf_counter()
    st = prob.solver_status
    req.iterations = int(st.num_iterations)
    req.solve_usec = int(st.timing.solve_usec)
    req.init_usec = int(st.timing.init_usec)
    req.ok = prob.status == "optimal"
    if not req.ok:
        req.error = f"status {prob.status}"
    req.answer = None if variable.value is None else family.answer(variable)
    return req
