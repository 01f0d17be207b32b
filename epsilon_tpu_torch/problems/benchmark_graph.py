"""Scaling graphs for benchmark results (counterpart of
``epsilon_tpu/problems/benchmark_graph.py``).  matplotlib is optional and
imported inside the functions, never when the module is loaded."""

from __future__ import annotations

from typing import Dict, List


def plot_results(results: List[Dict], path: str = "benchmark.png"):
    """Bar chart of solve times per problem."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        raise RuntimeError("matplotlib not available")
    names = [r["name"] for r in results if "time" in r]
    times = [r["time"] for r in results if "time" in r]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(names)), times)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=60, ha="right", fontsize=8)
    ax.set_ylabel("solve time (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def plot_scaling(sizes: List[int], times: List[float],
                 path: str = "scaling.png", label: str = "epsilon_tpu_torch"):
    """log-log scaling curve (``benchmark_graph.py`` style)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        raise RuntimeError("matplotlib not available")
    fig, ax = plt.subplots()
    ax.loglog(sizes, times, "o-", label=label)
    ax.set_xlabel("problem size")
    ax.set_ylabel("solve time (s)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path
