"""Benchmark harness of the port (counterpart of
``epsilon_tpu/problems/benchmark.py``).

Runs the problem suite through ``Problem.solve`` and reports, per row, the
seconds to build the problem, to compile it (with the write-back of the
values), to set up the solver and to solve, the iterations, ms per
iteration, the objective and, optionally, the device operations per
iteration of a profiled warm re-solve::

    python -m epsilon_tpu_torch.problems.benchmark --problem=lasso
    python -m epsilon_tpu_torch.problems.benchmark --reference --isolate
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import config


class ProblemInstance(NamedTuple):
    name: str
    create: Callable
    kwargs: Dict

    def create_problem(self):
        np.random.seed(0)
        out = self.create(**self.kwargs)
        if isinstance(out, tuple):
            return out[0]
        return out


def _p(mod):
    from . import (basis_pursuit, chebyshev, covsel, fused_lasso, group_lasso,  # noqa: F401
                   hinge_l1, hinge_l2, huber, infinite_push, lasso,
                   least_abs_dev, logreg_l1, lp, max_gaussian, max_softmax,
                   mnist, mv_lasso, oneclass_svm, portfolio, qp, quantile,
                   robust_pca, robust_svm, tv_1d, tv_denoise)
    return locals()[mod]


# The JAX package's default suite (its sizes, about 4x under the reference's).
PROBLEMS: List[ProblemInstance] = [
    ProblemInstance("basis_pursuit", _p("basis_pursuit").create, dict(m=300, n=1000)),
    ProblemInstance("covsel", _p("covsel").create, dict(m=30, n=60, lam=0.1)),
    ProblemInstance("fused_lasso", _p("fused_lasso").create, dict(m=250, ni=2, k=500)),
    ProblemInstance("group_lasso", _p("group_lasso").create, dict(m=375, ni=5, K=50)),
    ProblemInstance("hinge_l1", _p("hinge_l1").create, dict(m=375, n=2500)),
    ProblemInstance("hinge_l2", _p("hinge_l2").create, dict(m=1250, n=500)),
    ProblemInstance("huber", _p("huber").create, dict(m=1250, n=500)),
    ProblemInstance("lasso", _p("lasso").create, dict(m=375, n=2500)),
    ProblemInstance("least_abs_dev", _p("least_abs_dev").create, dict(m=1250, n=250)),
    ProblemInstance("logreg_l1", _p("logreg_l1").create, dict(m=375, n=2500)),
    ProblemInstance("lp", _p("lp").create, dict(m=200, n=400)),
    ProblemInstance("mnist", _p("mnist").create, dict(m=250, n=250, k=10)),
    ProblemInstance("mv_lasso", _p("mv_lasso").create, dict(m=375, n=625, k=4)),
    ProblemInstance("qp", _p("qp").create, dict(n=300)),
    ProblemInstance("quantile", _p("quantile").create, dict(m=100, n=10, k=5)),
    ProblemInstance("robust_pca", _p("robust_pca").create, dict(n=50)),
    ProblemInstance("tv_1d", _p("tv_1d").create, dict(n=25000)),
    ProblemInstance("tv_denoise", _p("tv_denoise").create, dict(n=50, lam=1.0)),
]

PROBLEMS_SMALL: List[ProblemInstance] = [
    ProblemInstance(p.name, p.create,
                    {k: (max(int(v // 10), 4) if isinstance(v, int) else v)
                     for k, v in p.kwargs.items()})
    for p in PROBLEMS
]


def PROBLEMS_REFERENCE() -> List[ProblemInstance]:
    """The reference's 27-row suite at the reference's sizes, including the
    three sparse (``mu``) variants; ``mnist`` uses the synthetic generator."""
    return [
        ProblemInstance("basis_pursuit", _p("basis_pursuit").create, dict(m=1000, n=3000)),
        ProblemInstance("chebyshev", _p("chebyshev").create, dict(m=100, n=200)),
        ProblemInstance("covsel", _p("covsel").create, dict(m=100, n=200, lam=0.1)),
        ProblemInstance("fused_lasso", _p("fused_lasso").create, dict(m=1000, ni=10, k=1000)),
        ProblemInstance("hinge_l1", _p("hinge_l1").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("hinge_l1_sparse", _p("hinge_l1").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("hinge_l2", _p("hinge_l2").create, dict(m=5000, n=1500)),
        ProblemInstance("hinge_l2_sparse", _p("hinge_l2").create, dict(m=10000, n=1500, mu=0.1)),
        ProblemInstance("huber", _p("huber").create, dict(m=5000, n=200)),
        ProblemInstance("infinite_push", _p("infinite_push").create, dict(m=100, n=200, d=20)),
        ProblemInstance("lasso", _p("lasso").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("lasso_sparse", _p("lasso").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("least_abs_dev", _p("least_abs_dev").create, dict(m=5000, n=200)),
        ProblemInstance("logreg_l1", _p("logreg_l1").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("logreg_l1_sparse", _p("logreg_l1").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("lp", _p("lp").create, dict(m=800, n=1000)),
        ProblemInstance("max_gaussian", _p("max_gaussian").create, dict(m=10, n=10, k=3)),
        ProblemInstance("max_softmax", _p("max_softmax").create, dict(m=100, k=20, n=50)),
        ProblemInstance("mnist", _p("mnist").create, dict(m=10000, n=1000, k=10)),
        ProblemInstance("mv_lasso", _p("lasso").create, dict(m=1500, n=5000, k=10, rho=0.01)),
        ProblemInstance("oneclass_svm", _p("oneclass_svm").create, dict(m=5000, n=200)),
        ProblemInstance("portfolio", _p("portfolio").create, dict(m=500, n=500000)),
        ProblemInstance("qp", _p("qp").create, dict(n=1000)),
        ProblemInstance("quantile", _p("quantile").create, dict(m=400, n=10, k=100, p=1)),
        ProblemInstance("robust_pca", _p("robust_pca").create, dict(n=100)),
        ProblemInstance("robust_svm", _p("robust_svm").create, dict(m=2000, n=600)),
        ProblemInstance("tv_1d", _p("tv_1d").create, dict(n=100000)),
    ]


def _scale_problems() -> List[ProblemInstance]:
    """Log-spaced size sweeps: the scaling curves behind the reference's
    benchmark graphs, built when asked for so that importing this module
    stays cheap."""
    out: List[ProblemInstance] = []
    out += [ProblemInstance(f"lasso_{int(m)}", _p("lasso").create,
                            dict(m=int(m), n=10 * int(m),
                                 rho=1 if m < 50 else 0.01))
            for m in np.logspace(1, np.log10(5000), 20)]
    out += [ProblemInstance(f"mv_lasso_{int(m)}", _p("mv_lasso").create,
                            dict(m=int(m), n=10 * int(m), k=10,
                                 rho=1 if m < 50 else 0.01))
            for m in np.logspace(1, np.log10(5000), 20)]
    out += [ProblemInstance(f"fused_lasso_{int(m)}", _p("fused_lasso").create,
                            dict(m=int(m), ni=10, k=int(m)))
            for m in np.logspace(1, 3, 20)]
    out += [ProblemInstance(f"hinge_l2_{int(n)}", _p("hinge_l2").create,
                            dict(m=10 * int(n), n=int(n)))
            for n in np.logspace(1, np.log10(5000), 20)]
    return out


def PROBLEMS_SCALE() -> List[ProblemInstance]:
    return _scale_problems()


def _sync():
    if config.on_cuda():
        torch.cuda.synchronize()


def device_ops_per_iteration(prob, iters: int, **params) -> Optional[float]:
    """Device operations per iteration of a warm re-solve of ``iters``
    iterations under ``torch.profiler`` (CUDA only: the count of events that
    ran on the card, kernels and copies; None on the CPU)."""
    if not config.on_cuda():
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = dict(params, warm_start=True, max_iterations=iters, rel_tol=1e-12,
               abs_tol=1e-12)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prob.solve(**run)
        _sync()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n / max(1, prob.solver_status.num_iterations)


def benchmark_epsilon(instance: ProblemInstance, rel_tol: float = 1e-3,
                      max_iterations: int = 50000, profile_iters: int = 0,
                      check: Optional[Callable] = None, **params) -> Dict:
    """One row: build, compile + write-back, solver set-up and solve timed
    apart.  ``check(prob)`` (if given) runs on the solution before the
    optional profiled re-solve and its dict joins the row."""
    t0 = time.time()
    prob = instance.create_problem()
    t_build = time.time() - t0
    _sync()
    t0 = time.time()
    obj = prob.solve(rel_tol=rel_tol, max_iterations=max_iterations,
                     warm_start=profile_iters > 0, **params)
    _sync()
    t_total = time.time() - t0
    st = prob.solver_status
    setup_s = st.timing.init_usec / 1e6
    solve_s = st.timing.solve_usec / 1e6
    iters = int(st.num_iterations)
    row = dict(
        name=instance.name, build_s=t_build,
        compile_s=max(0.0, t_total - setup_s - solve_s),
        setup_s=setup_s, solve_s=solve_s, time=t_total, iterations=iters,
        ms_per_iter=(1e3 * solve_s / iters) if iters else None,
        objective=float(obj), sign=float(prob._sign), status=prob.status)
    if check is not None:
        row.update(check(prob))
    if profile_iters and iters:
        row["device_ops_per_iter"] = device_ops_per_iteration(
            prob, profile_iters, **params)
    return row


def run_benchmarks(problems: List[ProblemInstance], **kwargs) -> List[Dict]:
    results = []
    for inst in problems:
        try:
            r = benchmark_epsilon(inst, **kwargs)
        except Exception as e:  # reporting path: the row records the error
            r = dict(name=inst.name, error=f"{type(e).__name__}: {e}")
        results.append(r)
        print(format_result(r), flush=True)
    return results


def run_benchmarks_isolated(problems: List[ProblemInstance],
                            suite_flags: Optional[List[str]] = None,
                            row_timeout: int = 600,
                            json_path: Optional[str] = None,
                            **kwargs) -> List[Dict]:
    """Each row in its own process under a hard timeout; an error row keeps
    the end of the child's stderr."""
    import subprocess
    import sys
    import tempfile

    results = []
    for inst in problems:
        with tempfile.NamedTemporaryFile("r", suffix=".json") as tf:
            cmd = ([sys.executable, "-m", "epsilon_tpu_torch.problems.benchmark"]
                   + list(suite_flags or [])
                   + ["--problem", inst.name, "--json", tf.name])
            for key in ("rel_tol", "max_iterations", "device"):
                if kwargs.get(key) is not None:
                    cmd += [f"--{key.replace('_', '-')}", str(kwargs[key])]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=row_timeout)
                data = json.load(open(tf.name)) if proc.returncode == 0 else None
                row = data[0] if data else dict(
                    name=inst.name, error=f"exit {proc.returncode}",
                    stderr=proc.stderr[-4000:])
            except subprocess.TimeoutExpired as e:
                row = dict(name=inst.name, error=f"timeout {row_timeout}s",
                           stderr=(e.stderr or b"")[-4000:].decode(errors="replace")
                           if isinstance(e.stderr, bytes) else (e.stderr or "")[-4000:])
        results.append(row)
        print(format_result(row), flush=True)
        if json_path:  # incremental: a cut run keeps its finished rows
            with open(json_path, "w") as f:
                json.dump(results, f, indent=1, default=float)
    return results


def format_result(r: Dict) -> str:
    if "error" in r:
        return f"{r['name']:16s} ERROR {r['error']}"
    ms = r.get("ms_per_iter")
    return (f"{r['name']:16s} build {r['build_s']:7.2f}s  compile {r['compile_s']:6.2f}s  "
            f"setup {r['setup_s']:7.2f}s  solve {r['solve_s']:7.2f}s  "
            f"iters={r['iterations']:6d}  ms/iter={ms if ms is None else round(ms, 4)}  "
            f"obj={r['objective']:.6e}  {r['status']}")


def format_table(results: List[Dict], fmt: str = "text") -> str:
    """The rows as one table: ``"text"`` (a :func:`format_result` line
    each), ``"html"`` or ``"latex"`` (problem, time, objective)."""
    nan = float("nan")
    if fmt == "html":
        rows = "".join(
            f"<tr><td>{r['name']}</td><td>{r.get('time', nan):.2f}</td>"
            f"<td>{r.get('objective', nan):.4e}</td></tr>"
            for r in results)
        return f"<table><tr><th>problem</th><th>time</th><th>objective</th></tr>{rows}</table>"
    if fmt == "latex":
        rows = "\\\\\n".join(
            f"{r['name']} & {r.get('time', nan):.2f} & "
            f"{r.get('objective', nan):.4e}"
            for r in results)
        return ("\\begin{tabular}{lrr}\nproblem & time & objective\\\\\n"
                + rows + "\\\\\n\\end{tabular}")
    return "\n".join(format_result(r) for r in results)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--problem", default=None)
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--reference", action="store_true",
                        help="the reference's 27-row suite at its sizes")
    parser.add_argument("--scale", action="store_true",
                        help="run the log-spaced size sweeps")
    parser.add_argument("--format", default="text",
                        choices=["text", "html", "latex"])
    parser.add_argument("--rel-tol", type=float, default=1e-3)
    parser.add_argument("--max-iterations", type=int, default=50000)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' for float64 on the host)")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write results as a JSON list")
    parser.add_argument("--isolate", action="store_true",
                        help="run each row in its own process under --row-timeout")
    parser.add_argument("--row-timeout", type=int, default=600)
    args = parser.parse_args()
    config.set_device(args.device)

    suite = PROBLEMS_SMALL if args.small else PROBLEMS
    if args.reference:
        suite = PROBLEMS_REFERENCE()
    if args.scale:
        suite = _scale_problems()
    if args.problem:
        suite = [p for p in suite if p.name == args.problem
                 or p.name.startswith(args.problem + "_")]
        if not suite:
            raise SystemExit(f"unknown problem {args.problem}")
    if args.isolate:
        flags = (["--scale"] if args.scale else ["--reference"] if args.reference
                 else ["--small"] if args.small else [])
        results = run_benchmarks_isolated(
            suite, suite_flags=flags, row_timeout=args.row_timeout,
            json_path=args.json, rel_tol=args.rel_tol,
            max_iterations=args.max_iterations, device=args.device)
    else:
        results = run_benchmarks(suite, rel_tol=args.rel_tol,
                                 max_iterations=args.max_iterations)
    if args.format != "text":
        print(format_table(results, args.format))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=float)


if __name__ == "__main__":
    main()
