"""The port's compiler (prox rules with the conic fallback of
``compiler/conic.py``) against the JAX package: every library row at a small
size, with ``use_epigraph`` on and off, compiles to the same prox-affine
problem.  The text form (``text_format``) must be equal, and so must every
term's kind, mode and parameters and every block of every operator and
offset (rtol 1e-12: both packages run the same numpy algebra on the same
data)."""

import numpy as np
import pytest

from epsilon_tpu.compiler import compiler as jcompiler
from epsilon_tpu.compiler import text_format as jtext
from epsilon_tpu.ir import ProxKind as JKind
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.compiler import compiler as tcompiler
from epsilon_tpu_torch.compiler import text_format as ttext
from torch_library_rows import ROWS, build


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                               rtol=1e-12, atol=1e-14)


def _assert_affine_equal(t, j):
    assert sorted(t.A.blocks) == sorted(j.A.blocks)
    for key, op in j.A.blocks.items():
        assert t.A.blocks[key].shape == op.shape
        _close(t.A.blocks[key].as_dense(), op.as_dense())
    assert sorted(t.b.keys()) == sorted(j.b.keys())
    for key in j.b.keys():
        _close(t.b[key], j.b[key])


@pytest.mark.parametrize("use_epigraph", [True, False], ids=["epi", "no_epi"])
@pytest.mark.parametrize("row", ROWS)
def test_compiled_problem_matches_jax(row, use_epigraph, monkeypatch):
    pj, pt = build(row, monkeypatch)
    cj = jcompiler.compile_problem(pj.expression_problem(), use_epigraph=use_epigraph)
    ct = tcompiler.compile_problem(pt.expression_problem(), use_epigraph=use_epigraph)
    assert ttext.format_problem(ct) == jtext.format_problem(cj)
    assert ct.var_dims == cj.var_dims
    assert len(ct.terms) == len(cj.terms)
    for tt, tj in zip(ct.terms, cj.terms):
        st, sj = tt.spec, tj.spec
        assert (st.kind.value, st.epigraph, st.alpha, st.k, st.axis) == \
            (sj.kind.value, sj.epigraph, sj.alpha, sj.k, sj.axis)
        assert [tuple(a) for a in st.arg_sizes] == [tuple(a) for a in sj.arg_sizes]
        assert sorted(st.scaled_zone_params or {}) == sorted(sj.scaled_zone_params or {})
        for key, val in (sj.scaled_zone_params or {}).items():
            _close(st.scaled_zone_params[key], val)
        _assert_affine_equal(tt.H, tj.H)
    assert [c.cone.value for c in ct.constraints] == [c.cone.value for c in cj.constraints]
    for c_t, c_j in zip(ct.constraints, cj.constraints):
        _assert_affine_equal(c_t.op, c_j.op)


def test_conic_fallback_reaches_cones_with_epigraph_off(monkeypatch):
    """With use_epigraph off the fallback adds exponential-cone epigraphs,
    second-order cones and non-negativity terms (the no_epi parameter set of
    tests/test_solve_suite.py) where the epigraph kernels would have been."""
    kinds = set()
    for row in ("infinite_push", "max_softmax", "oneclass_svm", "robust_svm"):
        pj, pt = build(row, monkeypatch)
        ct = tcompiler.compile_problem(pt.expression_problem(), use_epigraph=False)
        kinds |= {(t.spec.kind.value, t.spec.epigraph) for t in ct.terms}
    assert (JKind.EXP.value, True) in kinds
    assert (JKind.SECOND_ORDER_CONE.value, False) in kinds
    assert (JKind.NON_NEGATIVE.value, False) in kinds
