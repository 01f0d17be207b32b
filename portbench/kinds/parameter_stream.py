"""One Problem whose Parameters take each instance's values in turn; every
request sets them and re-solves warm on the program's cached solver
(``Problem.solve(warm_start=True)``: ``update_problem``).

With ``"restart": "new_problem"`` in the traffic, a request for the first
instance builds a new Problem instead and solves it cold, as a user does
who starts the next path of a regularization path: the traffic's order
``cycle`` then runs path after path, each from its first instance down."""

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
        self.solve_kwargs = dict(cfg["solve"], warm_start=True)
        self.calls = 0
        self.prob = self.params = self.variable = None

    def _instance(self):
        k = instance_order(self.traffic["order"], len(self.values), self.calls)
        self.calls += 1
        return k

    def _new_problem(self, k):
        self.prob = self.params = self.variable = None
        self.prob, self.params, self.variable = self.family.build(
            self.ep, self.cfg, self.data, self.values[k], parametric=True)

    def setup(self):
        """Build the problem on the first instance, solve it cold, then run
        the traffic's warm-up requests."""
        self._new_problem(self._instance())
        self.prob.solve(**self.solve_kwargs)
        for i in range(int(self.traffic["warmup"])):
            req = self.request(-1 - i)
            if not req.ok:
                raise RuntimeError(f"warm-up request failed: {req.error}")

    def request(self, index):
        k = self._instance()
        req = Request(index, k, time.perf_counter())
        try:
            if k == 0 and self.traffic.get("restart") == "new_problem":
                with self.span("portbench.build_problem"):
                    self._new_problem(k)
            else:
                with self.span("portbench.set_parameters"):
                    for name, param in self.params.items():
                        param.value = self.values[k][name]
            with self.span("portbench.solve"):
                self.prob.solve(**self.solve_kwargs)
            finish(req, self.prob, self.family, self.variable, self.sync)
        except Exception:  # a failed request is counted and reported; the stream goes on
            req.t1, req.error = time.perf_counter(), traceback.format_exc(limit=4)
        return req

    def close(self):
        self.prob = self.params = self.variable = None
