"""A third of the oracle matrix of ``tests/test_solve_suite.py`` on the port
(``torch_solve_suite``): these rows under the N-block and the no-epigraph
sets, and under the default two-block set those that
``tests/test_torch_library_{a,b,c}.py`` do not hold."""

import pytest

from torch_solve_suite import _cpu_one_thread, cases, run  # noqa: F401

CASES = cases(["oneclass_svm", "portfolio", "quantile", "robust_pca",
               "tv_1d", "tv_denoise"])


@pytest.mark.parametrize("row,params", CASES)
def test_port_meets_oracle(row, params, monkeypatch):
    run(monkeypatch, row, params)
