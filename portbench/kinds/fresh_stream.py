"""A new Problem for every request, its data as plain constants, solved
once with ``warm_start`` off: the frontend, the compiler, the solver's
set-up and a cold first solve run on every request."""

from __future__ import annotations

import time
import traceback

from ._common import Request, finish, instance_order, no_span


class Stream:
    """The requests of one run, in the traffic's order."""

    def __init__(self, ep, family, cfg, traffic, data, sync, span=no_span):
        self.ep, self.family, self.cfg, self.traffic = ep, family, cfg, traffic
        self.values = family.instances(cfg, traffic["instances"], data)
        self.data, self.sync, self.span = data, sync, span
        self.solve_kwargs = dict(cfg["solve"], warm_start=False)
        self.calls = 0

    def setup(self):
        """The traffic's warm-up requests (at least one): each builds and
        solves a problem as the window's requests do."""
        for i in range(max(1, int(self.traffic["warmup"]))):
            req = self.request(-1 - i)
            if not req.ok:
                raise RuntimeError(f"warm-up request failed: {req.error}")

    def request(self, index):
        k = instance_order(self.traffic["order"], len(self.values), self.calls)
        self.calls += 1
        req = Request(index, k, time.perf_counter())
        try:
            with self.span("portbench.build_problem"):
                prob, _, variable = self.family.build(
                    self.ep, self.cfg, self.data, self.values[k], parametric=False)
            with self.span("portbench.solve"):
                prob.solve(**self.solve_kwargs)
            finish(req, prob, self.family, variable, self.sync)
        except Exception:  # a failed request is counted and reported; the stream goes on
            req.t1, req.error = time.perf_counter(), traceback.format_exc(limit=4)
        return req

    def close(self):
        pass
