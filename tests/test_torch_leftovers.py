"""Small parts of ported modules that an earlier slice left out: the
benchmark's scale suite and table formats, ``native``'s TV-1D entry points,
the two-path dry run over a process group (two gloo processes on the CPU)
and the rule that picks the process group's backend."""

import numpy as np
import pytest

import torch_mesh_launch as ml
from epsilon_tpu_torch import config


@pytest.fixture(autouse=True)
def _cpu():
    config.set_device("cpu")


def test_benchmark_format_table_three_formats():
    """As ``tests/test_problems.py::test_benchmark_harness_smoke`` holds the
    JAX package: one tiny instance, then the table in text, html, latex."""
    from epsilon_tpu_torch.problems import benchmark, lasso
    inst = benchmark.ProblemInstance("lasso", lasso.create, dict(m=10, n=6))
    results = benchmark.run_benchmarks([inst], rel_tol=1e-2, max_iterations=500)
    assert len(results) == 1 and "error" not in results[0]
    assert "lasso" in benchmark.format_table(results, "text")
    assert "table" in benchmark.format_table(results, "html")
    assert "tabular" in benchmark.format_table(results, "latex")


@pytest.mark.parametrize("fmt", ["html", "latex"])
def test_benchmark_format_table_equals_jax(fmt):
    from epsilon_tpu.problems import benchmark as jbench
    from epsilon_tpu_torch.problems import benchmark as tbench
    rows = [dict(name="lasso", time=1.234, objective=5.6789e-3),
            dict(name="broken", error="x")]
    assert tbench.format_table(rows, fmt) == jbench.format_table(rows, fmt)


def test_benchmark_scale_suite_equals_jax():
    from epsilon_tpu.problems import benchmark as jbench
    from epsilon_tpu_torch.problems import benchmark as tbench
    ts, js = tbench.PROBLEMS_SCALE(), jbench.PROBLEMS_SCALE()
    assert [p.name for p in ts] == [p.name for p in js]
    assert [p.kwargs for p in ts] == [p.kwargs for p in js]
    assert len(ts) == 80


def test_native_tv1d_matches_jax_package():
    from epsilon_tpu import native as jnative
    from epsilon_tpu_torch import native as tnative
    rng = np.random.RandomState(0)
    y = np.cumsum(rng.randn(200))
    np.testing.assert_allclose(tnative.tv1d_prox(y, 1.5),
                               jnative.tv1d_prox(y, 1.5), atol=1e-10)
    Y = np.cumsum(rng.randn(5, 60), axis=1)
    lams = np.array([0.1, 0.5, 1.0, 2.0, 4.0])
    np.testing.assert_allclose(tnative.tv1d_prox_batch(Y, lams),
                               jnative.tv1d_prox_batch(Y, lams), atol=1e-10)
    np.testing.assert_allclose(tnative.tv1d_prox_batch(Y, 0.7)[2],
                               tnative.tv1d_prox(Y[2], 0.7), atol=0)
    assert tnative.available() is False


def test_dryrun_multichip_over_gloo():
    """Two iterations of the sharded consensus solve and four of a
    term-sharded ``Problem.solve`` by two processes: finite, and the same
    on both ranks."""
    ranks = ml.run_workers(2, ["dryrun"])
    a, b = ranks[0]["dryrun"], ranks[1]["dryrun"]
    assert np.all(np.isfinite(a["z"])) and np.isfinite(a["objective"])
    np.testing.assert_array_equal(a["z"], b["z"])
    assert float(a["objective"]) == float(b["objective"])


@pytest.mark.parametrize("cards,world,on_cuda,want", [
    (0, 4, False, ("gloo", None)),     # the CPU
    (1, 4, True, ("gloo", 0)),         # four ranks share the one card
    (4, 4, True, ("nccl", 2)),         # a card a rank
    (8, 4, True, ("nccl", 2)),
    (2, 4, True, ("gloo", 0)),
    (1, 1, True, ("nccl", 0)),
])
def test_choose_backend_follows_the_machine(monkeypatch, cards, world, on_cuda, want):
    import torch
    from epsilon_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(distributed.config, "on_cuda", lambda: on_cuda)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    rank = 2 if world > 2 else 0
    assert distributed.choose_backend(world, rank) == want


@pytest.mark.parametrize("local_env,rank,want", [
    # eight ranks on two machines of four cards: the launcher's variables
    ({"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, 5, ("nccl", 1)),
    # no LOCAL_RANK: the rank modulo the machine's cards
    ({"LOCAL_WORLD_SIZE": "4"}, 6, ("nccl", 2)),
    # eight ranks on this machine's four cards share card 0 over gloo
    ({"LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "5"}, 5, ("gloo", 0)),
    ({}, 5, ("gloo", 0)),
])
def test_choose_backend_counts_this_machines_processes(monkeypatch, local_env, rank, want):
    import torch
    from epsilon_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(distributed.config, "on_cuda", lambda: True)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in local_env.items():
        monkeypatch.setenv(name, value)
    assert distributed.choose_backend(8, rank) == want
