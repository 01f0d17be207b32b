"""Run one cell once: set-up, a measured window of requests through the
program's ``Problem.solve``, an optional device trace, the check against
the plain reference, and the result line."""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

from . import spec as spec_mod
from .kinds._common import Request, no_span

FORBIDDEN = ("jax", "jaxlib", "flax", "epsilon_tpu")


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py`` ``read(run)``)."""
    cell: spec_mod.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: List[Request] = field(default_factory=list)
    traced: List[Request] = field(default_factory=list)
    trace: object = None          # trace.Trace of the profiled requests, or None


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, the part before
    the first dot, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def port_module():
    """The program under test, which must be the checkout's own."""
    import epsilon_tpu_torch as ep
    where = Path(ep.__file__).resolve().parents[1]
    if where != spec_mod.ROOT:
        raise RuntimeError(f"epsilon_tpu_torch loaded from {where}, not from the "
                           f"checkout {spec_mod.ROOT}")
    return ep


def _sample_instances(requests, count, rng, last=False):
    """The instances whose answers are checked: ``count`` drawn from the
    seed among those the window served, the instance of its longest
    request and, with ``last``, the last instance that it served."""
    served = sorted({r.instance for r in requests})
    picked = set(rng.choice(served, size=min(count, len(served)), replace=False).tolist())
    longest = max(requests, key=lambda r: (r.iterations, r.seconds))
    picked.add(longest.instance)
    if last:
        picked.add(served[-1])
    return sorted(picked)


def check(cell, family, data, requests, seed, device):
    """Compare every answer of the sampled instances with the reference.
    Returns ``{number: (worst value, limit)}``."""
    cfg, traffic = cell.config, cell.traffic
    limits = cfg["check"]["limits"]
    if not requests:
        return {name: (float("inf"), float(limits[name])) for name in limits}
    values = family.instances(cfg, traffic["instances"], data)
    rng = np.random.default_rng([seed, 1])
    chosen = _sample_instances(requests, int(traffic["check_instances"]), rng,
                               last=bool(traffic.get("check_last")))
    refs = dict(zip(chosen, family.references(cfg, data, [values[k] for k in chosen],
                                              device=device)))
    worst = {name: 0.0 for name in limits}
    for r in requests:
        if r.instance in refs:
            for name, v in family.compare(cfg, data, values[r.instance], r.answer,
                                          refs[r.instance]).items():
                worst[name] = max(worst[name], v)
    return {name: (worst[name], float(limits[name])) for name in limits}


class _Profiler:
    """``torch.profiler`` over requests ``[first, last)`` of the window, and
    the spans that mark what those requests do (no-ops while it is off)."""

    def __init__(self, on, first, last, on_cuda):
        self.on, self.first, self.last, self.on_cuda = on, first, last, on_cuda
        self.prof = None
        self.active = False

    def span(self, name):
        if not self.active:
            return no_span(name)
        from torch.profiler import record_function
        return record_function(name)

    def before(self, i):
        if self.on and i == self.first:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_cuda else [])
            self.prof = profile(activities=activities)
            self.prof.__enter__()
            self.active = True

    def after(self, i):
        if self.active and i == self.last - 1:
            self.stop()

    def stop(self):
        if self.active:
            self.prof.__exit__(None, None, None)
            self.active = False


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", stderr=sys.stderr):
    """One run.  Returns ``(result dict, checks)``: the result line's
    object without its ``checks`` key, and ``{number: (value, limit)}``."""
    import torch

    from . import trace as trace_mod

    ep = port_module()
    cfg, traffic = cell.config, cell.traffic
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    family = importlib.import_module(f"portbench.problems.{cfg['family']}")
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")

    data = family.generate(cfg, traffic["instances"], np.random.default_rng(seed))
    run = Run(cell)
    tcfg = traffic["trace"]
    profiler = _Profiler(trace, int(tcfg["skip"]), int(tcfg["skip"]) + int(tcfg["requests"]),
                         on_cuda)
    stream = kind.Stream(ep, family, cfg, traffic, data, sync, profiler.span)
    stream.setup()
    sync()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    i = 0
    while time.perf_counter() < t0 + seconds:
        profiler.before(i)
        traced = profiler.active
        with profiler.span(trace_mod.REQUEST_SPAN):
            req = stream.request(i)
        run.requests.append(req)
        if traced:
            run.traced.append(req)
        profiler.after(i)
        i += 1
    profiler.stop()
    sync()
    run.window_s = run.requests[-1].t1 - t0
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0

    # free the program's state before the reference runs on the device
    stream.close()
    del stream
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    if profiler.prof is not None:
        run.trace = trace_mod.from_profiler(profiler.prof)
        profiler.prof = None

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_mod.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    failed = sum(1 for r in run.requests if not r.ok)
    checks = check(cell, family, data, [r for r in run.requests if r.ok], seed, device)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(run.requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    for r in run.requests:
        if not r.ok:
            print(f"request {r.index} (instance {r.instance}) failed: {r.error}", file=stderr)
    return result, checks


def checks_field(checks: Dict) -> Dict:
    return {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}


def emit(result, checks, stdout=sys.stdout, stderr=sys.stderr):
    """The compared numbers as the last lines of standard error, then the
    result line, with the same numbers under its last key, as the last
    line of standard output."""
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v!r} (limit {lim!r})", file=stderr)
    stderr.flush()
    line = dict(result)
    line["checks"] = checks_field(checks)
    print(json.dumps(line), file=stdout)
    stdout.flush()
