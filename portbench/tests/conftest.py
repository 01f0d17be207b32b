"""Tiny sizes for the configurations that ``tiny.TINY`` does not name,
from a configuration file's own ``tiny`` key (its keys and values at the
size the CPU tests run), added before any test runs, so that the cell and
contract tests run every cell of ``BENCHMARK.json``.

A file's ``tiny_traffic`` key, where there is one, updates the traffic of
the configuration's tiny cells: a tiny run's second does not reach the
98th request, where the profiled requests of a path of 100 instances
start, so its tiny runs walk paths of 4 and profile from the next path's
cold build on."""

import copy

import pytest

from portbench import spec
from portbench.tests import tiny

_TINY_TRAFFIC = {}
for _config in spec.load_json(spec.ROOT / "BENCHMARK.json")["configs"]:
    _file = spec.load_json(spec.ROOT / _config["file"])
    if "tiny" in _file and _config["name"] not in tiny.TINY:
        tiny.TINY[_config["name"]] = dict(_file["tiny"])
        if "tiny_traffic" in _file:
            _TINY_TRAFFIC[_config["name"]] = _file["tiny_traffic"]

if _TINY_TRAFFIC:
    _tiny_cell = tiny.tiny_cell

    def _tiny_cell_with_its_traffic(workload):
        cell = _tiny_cell(workload)
        cell.traffic.update(copy.deepcopy(_TINY_TRAFFIC.get(cell.config["name"], {})))
        return cell

    tiny.tiny_cell = _tiny_cell_with_its_traffic


@pytest.fixture(scope="session", autouse=True)
def profiler_started_once():
    """Start and stop a ``torch.profiler`` once before the tests: its first
    start in a process takes seconds, which would otherwise fall inside the
    one-second window of the first tiny run that profiles."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    yield
