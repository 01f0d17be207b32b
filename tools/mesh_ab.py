"""Phase 9 (e)'s wide family on four ranks of one card, run by the package
of each checkout given: the A/B of the meshed loop across two trees of this
repository in one call (for instance the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists, against this tree).

    python3 tools/mesh_ab.py <checkout> [<checkout> ...]

Each checkout gets a launch of four ranks that import its own
``epsilon_tpu_torch`` and ``tools/mesh_worker.py`` helpers (which every tree
since the meshed path has), solve 64 blocks of 200 x 2000 with NORM_1 on z
through ``Problem.solve(mesh=group)`` and time three warm re-solves of 50
iterations; rank 0 prints one JSON line: the groups and buckets, iterations,
set-up and solve seconds, ms/iteration (median, min, max), collectives and
device operations per iteration on rank 0, operator bytes and the values of
z a rank holds.  Give the checkouts in turns (A B B A) to see the spread.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# (e)'s problem and solve, as ``tools/mesh_worker.py`` states them
WIDE_SIZES = (64, 200, 2000)
WIDE = dict(rel_tol=1e-3, abs_tol=1e-6, rho=1.0, max_iterations=3000)
STEADY_ITERS = 50


def rank_main(checkout, rank, world, rendezvous, out, device="cuda",
              sizes=WIDE_SIZES):
    sys.path.insert(0, os.path.abspath(checkout))
    from tools import mesh_worker as mw
    assert os.path.dirname(os.path.dirname(os.path.abspath(mw.__file__))) == \
        os.path.abspath(checkout), mw.__file__
    ep, group, backend = mw.start(rank, world, rendezvous, device)
    A, b = mw.consensus_blocks(*sizes)
    t0 = time.perf_counter()
    prob, z, xs = mw.consensus_problem(ep, A, b, mw.LAM)
    prob.solve(mesh=group, warm_start=True, **WIDE)
    mw._sync()
    wall = time.perf_counter() - t0
    solver, st = mw.cached_solver(prob), prob.solver_status
    res = dict(checkout=checkout, backend=backend,
               groups=[g.S for g in solver.scn_groups],
               buckets=[len(bkt) for bkt in (solver.buckets or [])],
               status=prob.status, iterations=st.num_iterations, wall_s=wall,
               setup_s=st.timing.init_usec / 1e6, solve_s=st.timing.solve_usec / 1e6,
               bytes=solver.operator_bytes(),
               z_values=sum(v.numel() for v in solver._warm_state[0].data.values()))

    def resolve(**kw):
        prob.solve(mesh=group, warm_start=True, **dict(WIDE, **kw))
        return prob.solver_status
    res["steady"] = mw._steady(resolve, STEADY_ITERS, solver, rank == 0)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f, default=float)
    mw.finish(group)


def main(checkouts, world=4, timeout=900):
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or world) // world)))
    for checkout in checkouts:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "rank0.json")
            rendezvous = os.path.join(td, "rendezvous")
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "rank", checkout,
                 str(rank), str(world), rendezvous, out], env=env)
                for rank in range(world)]
            try:
                codes = [p.wait(timeout=timeout) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(codes):
                raise RuntimeError(f"{checkout}: ranks exited with codes {codes}")
            with open(out) as f:
                res = json.load(f)
            res["launch_s"] = time.perf_counter() - t0
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                  sys.argv[6])
        sys.stdout.flush()
        # leave without the interpreter's teardown (see tools/mesh_worker.py)
        os._exit(0)
    main(sys.argv[1:])
