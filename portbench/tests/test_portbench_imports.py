"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either.  Module names are compared
by their top-level name (the part before the first dot) as a whole:
``epsilon_tpu_torch`` is not ``epsilon_tpu``."""

import json
import subprocess
import sys

from portbench import harness, spec

RUN_ALL_CELLS = """
import json, sys
import torch
torch.set_num_threads(1)
from portbench import spec
from portbench.tests.tiny import run_tiny
import portbench.run
for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]:
    spec.metric_reader(m["name"])
for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
    for trace in (False, True):
        run_tiny(w["name"], trace=trace, seconds=0.3)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

RUN_REFERENCE = """
import json, sys
import numpy as np, torch
from portbench.problems import generators as G
from portbench.reference import covsel, tv1d
v = G.tv1d_signals(200, 1, np.random.default_rng(0), np.random.default_rng(1))[0]
tv1d.tv1d_exact(v, 3.0); tv1d.tv1d_exact(v, 3.0, tv1d.round_bf16)
S = torch.tensor(G.covsel_covariance(10, np.random.default_rng(0), np.random.default_rng(1)))
covsel.glasso(S, 1 - torch.eye(10, dtype=torch.float64), 0.1)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    names = _top_level_names(RUN_ALL_CELLS)
    assert "epsilon_tpu_torch" in names and "portbench" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_program():
    names = _top_level_names(RUN_REFERENCE)
    assert not names & (set(harness.FORBIDDEN) | {"epsilon_tpu_torch"})


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["epsilon_tpu_torch", "epsilon_tpu_torch.ops",
                                      "jaxtyping", "flaxen.x", "portbench"]) == []
    assert harness.forbidden_modules(["jax.numpy", "epsilon_tpu.ops", "jaxlib", "flax"]) == [
        "epsilon_tpu", "flax", "jax", "jaxlib"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "tv1d_1m.signal_stream", "--seed", str(2**31 + 1), "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
