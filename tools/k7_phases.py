"""Where a round of K7 (the TV-1D PDAS kernel, ``csrc/tv1d_pdas.cu``) spends
its time, phase by phase, on the card.

    python3 -m tools.k7_phases [n ...]          (from the repository root)

Builds ``csrc/tv1d_pdas.cu`` with ``-DK7_PHASE_MARKS`` (its own library
under ``build/kernels/``; the port's build has no marks), in which thread 0
of block 0 reads ``clock64()`` at the phase boundaries of every round of
both builds (``MARK`` in the source: the tile build, ``pdas_tiles``, and the
levels build it replaced, ``pdas_levels``), and runs the tile build on its
plan (``tiles``), on the same K with levels K..steps-2 in device memory
where its plan has the residue stage (``tiles dev``), and the levels build,
at each n given (10,000, 100,000 and 1,000,000 when none is), f32 and f64,
cold and warm at the solver's inner tolerance, as ``tools/profile_port.py
--k7-tiles`` does.  Prints the median cycles of each phase over the
rounds (block 0's view: a phase that ends in a grid sync includes the wait
for the slowest block, and on an SM that keeps two blocks, for the other
one), the device ms of a call (of the marked build), the grid syncs it
counted, and a JSON line.
"""

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

# csrc/tv1d_pdas.cu MARK_ROUNDS and MARKS
MARK_ROUNDS, MARKS = 64, 11
TILE_PHASES = ["tile stage", "its grid sync", "residue stage or levels in device memory",
               "residue sync", "trials (last level merged without the residue stage)",
               "trial sync", "trial sums", "step, next start merged", "step sync", "stop test"]
PHASES = {
    "tiles": TILE_PHASES,
    "tiles dev": TILE_PHASES,
    "levels": ["start", "its grid sync", "PCR levels, a sync each", "trials", "trial sync",
               "trial sums", "step", "step sync", "stop test"],
}


def marked_library():
    """The library of ``csrc/tv1d_pdas.cu`` built with the phase marks,
    typed as the port's."""
    from epsilon_tpu_torch.ops.kernels import _rows
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
    lib = _rows.load("tv1d_pdas", k7.entries(), extra=("-DK7_PHASE_MARKS",))
    lib.tv1d_pdas_set_marks.argtypes = [ctypes.c_void_p]
    lib.tv1d_pdas_set_marks.restype = ctypes.c_int
    return lib


SIZES = (10_000, 100_000, 1_000_000)


def main(argv):
    sizes = tuple(int(a) for a in argv) or SIZES
    if not torch.cuda.is_available():
        print("k7_phases: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import LIBRARY_REL_TOL, device_ms, tv_signal
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    lib = marked_library()
    saved, results = k7._LIB, {}
    k7._LIB = lib
    counter = k7.sync_counter(dev)
    try:
        for dtype, floor in ((torch.float32, 3e-4), (torch.float64, 1e-7)):
            tol = max(0.1 * LIBRARY_REL_TOL, floor)
            for n in sizes:
                v = torch.as_tensor(tv_signal(n, 1), dtype=dtype, device=dev)
                lam = float(np.sqrt(n))
                z_cold = k7.pdas_levels(v, lam, tol)[1]
                v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(2).randn(n), dtype=dtype,
                                                device=dev)
                rule = k7.plan_for(v)
                plans = {"tiles": rule, "levels": None}
                if rule.residue:
                    plans["tiles dev"] = k7.tile_plan(n - 1, k7.grid("pdas", n, v),
                                                      v.element_size(), residue=False)
                for kind, z0 in (("cold", None), ("warm", z_cold)):
                    args = k7._pdas_args("tv1d_pdas", v2, lam, z0)
                    for build_name, plan in plans.items():
                        def call():
                            return k7._launch_pdas(args, tol, 40, build_name.split()[0], plan)
                        ms = device_ms(call, reps=20)
                        marks = torch.zeros(MARK_ROUNDS * MARKS, dtype=torch.int64, device=dev)
                        if lib.tv1d_pdas_set_marks(marks.data_ptr()) != 0:
                            raise RuntimeError("tv1d_pdas_set_marks failed")
                        counter.zero_()
                        rounds = int(call()[3])
                        syncs = int(counter)
                        lib.tv1d_pdas_set_marks(None)
                        t = marks.cpu().numpy().reshape(MARK_ROUNDS, MARKS)[
                            :min(rounds, MARK_ROUNDS), :len(PHASES[build_name]) + 1]
                        phases = [float(np.median(d)) for d in np.diff(t, axis=1).T]
                        per_round = float(np.median(t[:, -1] - t[:, 0]))
                        key = f"{build_name} n={n} {str(dtype)[6:]} {kind}"
                        results[key] = {"ms": ms, "rounds": rounds, "grid_syncs": syncs,
                                        "round_cycles": per_round,
                                        "phase_cycles": dict(zip(PHASES[build_name], phases))}
                        print(f"[k7-phases] {key}: {ms:.4f} ms, {rounds} rounds, {syncs} grid "
                              f"syncs, {per_round:.0f} cycles a round (median): "
                              + "; ".join(f"{p} {c:.0f}" for p, c in
                                          zip(PHASES[build_name], phases)), flush=True)
    finally:
        k7._LIB = saved
    print(json.dumps({"k7_phases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
