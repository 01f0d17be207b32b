"""Expected objectives of the problem library, made by the JAX package.

    python -m tools.library_reference [--params SET] [--rows a,b]
        [--timeout S] [--max-iterations N]

Solves every row of ``epsilon_tpu.problems.benchmark.PROBLEMS_REFERENCE``
(the reference sizes) with the JAX package in float64 on the CPU, each row
in its own process under a time and memory limit, and writes
``tests/data/library_reference.json``: per row the objective of the
minimization form (for a Maximize row, the negated user objective), the
sign that maps it to the user's objective, the iterations, the state, the
iteration cap and the seconds.  Rows already in the file are kept unless
named with ``--rows``.

``--params`` names one of the oracle matrix's three parameter sets
(``PARAM_SETS``): ``two_block``, the default, whose rows are the file's
``rows``; ``n_block`` and ``no_epi``, each under a key of its own that also
holds the solver parameters the set adds.  ``chip_smoke.py`` holds the
port's f32 solves on the card to these values with the oracle matrix's
one-sided test (``tests/test_solve_suite.py``): phase 7 to ``rows``, phase
7c to the other two sets.  ``--max-iterations`` caps the rows named with
``--rows``; the cap is stored with each row, and phase 7c solves such a row
at the same cap.

The rows solve at the harness's parameters (``benchmark_epsilon``:
rel_tol 1e-3, at most 50000 iterations, the solver's other defaults), the
parameters phase 7 solves at.  A tighter reference is out of reach on the
CPU: at rel_tol 1e-5 ``infinite_push`` and ``max_gaussian`` still ran to
20000 iterations (83 s and 5.5 s).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "data" / "library_reference.json"
REL_TOL = 1e-3
MAX_ITERATIONS = 50000
MEMORY_GB = 16
# The oracle matrix's parameter sets (tests/test_solve_suite.py ``PARAMS``)
# by the ids the tests give them; the solver is named by its string, which
# either package's SolverParams reads.
PARAM_SETS = {
    "two_block": {},
    "n_block": {"solver": "prox_admm"},
    "no_epi": {"use_epigraph": False},
}


def section(data: dict, params: str) -> dict:
    """The part of the file that holds one set's ``rows``: the file itself
    for two_block, else the set's own key."""
    if params == "two_block":
        return data
    return data.setdefault(params, {"params": PARAM_SETS[params], "rows": {}})


def _solve_row(name: str, params: str = "two_block",
               max_iterations: int = MAX_ITERATIONS) -> dict:
    """Runs in the child: one row through the JAX package, f64 on the CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from epsilon_tpu.problems import benchmark

    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == name)
    t0 = time.time()
    prob = inst.create_problem()
    t1 = time.time()
    obj = prob.solve(rel_tol=REL_TOL, max_iterations=max_iterations,
                     **PARAM_SETS[params])
    st = prob.solver_status
    return dict(name=name, kwargs=inst.kwargs, objective=float(obj),
                sign=float(prob._sign), iterations=int(st.num_iterations),
                status=prob.status, rel_tol=REL_TOL,
                max_iterations=max_iterations,
                build_s=round(t1 - t0, 3), solve_s=round(time.time() - t1, 3))


def _child(name: str, path: str, params: str, max_iterations: int):
    cap = MEMORY_GB << 30
    resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
    row = _solve_row(name, params, max_iterations)
    with open(path, "w") as f:
        json.dump(row, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="two_block", choices=sorted(PARAM_SETS),
                    help="the parameter set the rows solve under")
    ap.add_argument("--rows", default=None, help="comma-separated row names")
    ap.add_argument("--timeout", type=int, default=1800, help="seconds per row")
    ap.add_argument("--max-iterations", type=int, default=MAX_ITERATIONS,
                    help="iteration cap of the rows named with --rows")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child, args.out, args.params, args.max_iterations)
        return

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    from epsilon_tpu.problems import benchmark
    names = [p.name for p in benchmark.PROBLEMS_REFERENCE()]
    if args.rows:
        wanted = args.rows.split(",")
        unknown = set(wanted) - set(names)
        if unknown:
            raise SystemExit(f"unknown rows {sorted(unknown)}")
        names = [n for n in names if n in wanted]
    elif args.max_iterations != MAX_ITERATIONS:
        raise SystemExit("--max-iterations caps the rows named with --rows")
    data = json.loads(OUT.read_text()) if OUT.exists() else {"rows": {}}
    if not args.rows:
        names = [n for n in names if n not in section(data, args.params)["rows"]]
    # a scratch file per set, so that two sets can be made side by side
    tmp = OUT.with_suffix(f".{args.params}.row.json")
    for name in names:
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "tools.library_reference", "--child", name,
                 "--out", str(tmp), "--params", args.params,
                 "--max-iterations", str(args.max_iterations)],
                cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
            if proc.returncode != 0:
                print(f"{args.params} {name}: failed rc={proc.returncode}\n"
                      f"{proc.stderr[-2000:]}", flush=True)
                continue
            row = json.loads(tmp.read_text())
        except subprocess.TimeoutExpired:
            print(f"{args.params} {name}: timed out after {args.timeout} s", flush=True)
            continue
        # read the file again: the run of another set may have written it
        data = json.loads(OUT.read_text()) if OUT.exists() else {"rows": {}}
        section(data, args.params)["rows"][name] = row
        data.update(made_by="epsilon_tpu (JAX package), float64 on the CPU",
                    rel_tol=REL_TOL, max_iterations=MAX_ITERATIONS)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        part = OUT.with_suffix(f".{args.params}.json.part")
        part.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
        os.replace(part, OUT)
        print(f"{args.params} {name}: obj {row['objective']:.10g} iters "
              f"{row['iterations']} {row['status']} {time.time() - t0:.1f} s", flush=True)
    if tmp.exists():
        tmp.unlink()


if __name__ == "__main__":
    main()
