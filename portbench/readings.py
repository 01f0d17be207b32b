"""The readings that the check's limits are set from, on the chip at a
cell's own size, many seeds in one process:

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 --seconds 5 \\
        --side program|control|state_unchanged|answer_altered

``program``: sound runs of the cell (the lower readings).  ``control``:
each of the configuration's precision controls (``check.controls``), one
record a control and seed: ``program_tf32`` runs the cell with the
program's TF32 path on; ``reference_bf16`` and ``reference_tf32`` put the
reference, computed in that precision, in the program's place for the
instances a check samples.  The faults: the cell with the fault of that
name planted under its timed path (:mod:`portbench.faults`).  One JSON
line a seed.  A short window is enough: the numbers compared do not depend
on its length.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_from_reference(cell, seed, device="cuda"):
    """The readings of the reference computed in the control's precision,
    put in the program's place: one answer for each of as many instances
    as a check samples, judged as the check judges the program's."""
    import importlib

    import numpy as np

    from .harness import check
    from .kinds._common import Request

    cfg, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"portbench.problems.{cfg['family']}")
    data = family.generate(cfg, traffic["instances"], np.random.default_rng(seed))
    values = family.instances(cfg, traffic["instances"], data)
    chosen = set(np.random.default_rng([seed, 1]).choice(
        len(values), size=min(int(traffic["check_instances"]), len(values)),
        replace=False).tolist())
    if traffic.get("check_last"):
        chosen.add(len(values) - 1)
    chosen = sorted(chosen)
    low = family.references(cfg, data, [values[k] for k in chosen], control=True, device=device)
    answers = [Request(i, int(k), 0.0, ok=True, answer=a)
               for i, (k, a) in enumerate(zip(chosen, low))]
    return check(cell, family, data, answers, seed, device)


def readings(cell, seeds, seconds, side, device="cuda"):
    """Yield one record a seed."""
    from . import faults, harness

    modes = [c["mode"] for c in cell.config["check"]["controls"]] if side == "control" else [None]
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    for seed in seeds:
        for mode in modes:
            # planted anew for each seed, as each run of the command plants it
            while saved:
                setattr(*saved.pop())
            if side in faults.FAULTS:
                faults.FAULTS[side](patch)
            elif mode in faults.CONTROLS:
                faults.CONTROLS[mode](patch)
            t0 = time.perf_counter()
            if mode is not None and mode.startswith("reference_"):
                checks, extra = control_from_reference(cell, seed, device), {}
            else:
                try:
                    result, checks = harness.run_cell(cell, seed, seconds, False, t0,
                                                      device=device)
                except Exception as e:  # a control or fault that crashes has failed
                    result, checks = None, {}
                    extra = {"correct": False, "crashed": repr(e)[-300:]}
                if result is not None:
                    extra = {"correct": result["correct"], "attempted": result["attempted"],
                             "failed": result["failed"],
                             "solves_per_s": result["metrics"].get("solves_per_s", {}).get("value")}
            yield dict({"workload": cell.name, "side": mode or side, "seed": seed,
                        "readings": {k: v for k, (v, _) in checks.items()},
                        "seconds": time.perf_counter() - t0}, **extra)
    while saved:
        setattr(*saved.pop())


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.readings", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--side", required=True,
                   choices=["program", "control", "state_unchanged", "answer_altered"])
    args = p.parse_args(argv)
    from . import spec
    cell = spec.load_cell(args.workload)
    for rec in readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, args.side):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
