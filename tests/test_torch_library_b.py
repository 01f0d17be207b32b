"""Library rows infinite_push to max_softmax (a third of ``PROBLEMS_REFERENCE``, at the
small sizes of ``torch_library_rows.SMALL``) through ``Problem.solve`` in both
packages, held to each other by ``torch_library_rows.check_row`` (same state
and iteration count; residual series rtol 1e-6, values atol 1e-7, objective
rtol 1e-9, f64 on the CPU); and some rows' independent oracles of
``tests/test_solve_suite.py`` (scipy, sklearn, numpy), run on the port."""

import pytest

import epsilon_tpu_torch as et
import test_solve_suite as suite
from epsilon_tpu_torch import config as tconfig
from torch_library_rows import check_row

ROWS = ['infinite_push', 'lasso', 'lasso_sparse', 'least_abs_dev', 'logreg_l1', 'logreg_l1_sparse', 'lp', 'max_gaussian', 'max_softmax']


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


@pytest.mark.parametrize("row", ROWS)
def test_row_matches_jax(row, monkeypatch):
    check_row(row, monkeypatch)


@pytest.mark.parametrize("oracle", ['test_infinite_push', 'test_logreg_l1', 'test_lp', 'test_max_gaussian'])
def test_port_meets_solve_suite_oracle(oracle, monkeypatch):
    # the solve suite's default parameter set, with its problems built by
    # the port instead of the JAX package
    monkeypatch.setattr(suite, "ep", et)
    getattr(suite, oracle)(dict())
