"""Error types with pretty printing (counterpart of
``epsilon_tpu/error.py``)."""

from __future__ import annotations


class EpsilonError(Exception):
    pass


class ProblemError(EpsilonError):
    def __init__(self, message, problem=None):
        super().__init__(message)
        self.problem = problem

    def __str__(self):
        base = super().__str__()
        if self.problem is not None:
            try:
                from .compiler import text_format
                return f"{base}\n{text_format.format_problem(self.problem)}"
            except Exception:
                pass
        return base


class ExpressionError(EpsilonError):
    def __init__(self, message, *exprs):
        super().__init__(message)
        self.exprs = exprs

    def __str__(self):
        base = super().__str__()
        if self.exprs:
            try:
                from .frontend import tree_format
                dumps = "\n".join(tree_format.format_expr(e) for e in self.exprs)
                return f"{base}\n{dumps}"
            except Exception:
                pass
        return base


class LinearMapError(EpsilonError):
    pass


class SolveError(EpsilonError):
    """Solver-side failure (the reference converts glog CHECK failures into
    this via setjmp/longjmp, ``solvemodule.cc:245-248``)."""
