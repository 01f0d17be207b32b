"""The port's benchmark: run one cell once and print its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 portbench/run.py ...``) from the root of a checkout that
holds ``epsilon_tpu_torch``.  The cells, their configurations, traffic and
metrics are named in ``BENCHMARK.json`` and found under ``portbench/``.
Exits with a code other than 0, and prints no result, without enough CUDA
devices, without the program in the checkout, or when a module of JAX or
of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"
# Every compiler cache a run could fill lives at a fixed path in the checkout.
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda", "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
