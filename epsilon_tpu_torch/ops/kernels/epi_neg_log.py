"""The SUM_NEG_LOG epigraph per row as one kernel launch
(``csrc/epi_neg_log.cu``); on the main path it projects the spectrum of a
NEG_LOG_DET epigraph (``ops/prox/matrix.py``).

The JAX package compiles ``epi_sum_neg_log`` (``epsilon_tpu/ops/prox/elementwise.py``,
through ``newton_epi.make_epigraph``), its 24-step implicit Newton
(``lax.fori_loop``) included, into one device program per call.  The
port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.epi_sum_neg_log_reference`)
issues every loop step as eager operations; the kernel runs one row in one
warp.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's loop stops once its state
repeats, which gives the full-count result bitwise; :func:`epi_rows_full`
launches the build that runs the loop to its count, the reference that
exit is checked against (no dispatch calls it).  ``steps``, where given,
receives each row's step counts (``_rows.STEP_COUNTS``).
"""

from __future__ import annotations

import ctypes

from . import _rows

__all__ = ["epi_rows", "epi_rows_full", "build", "launches"]

# Kernel launches made by epi_rows (the full-count build's are not counted).
launches = 0

_LIB = None


def build():
    """Compile ``csrc/epi_neg_log.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("epi_neg_log")


def _library():
    global _LIB
    if _LIB is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        args = [P, P, I, "scalar", P, P, P, I, I, P]
        _LIB = _rows.load("epi_neg_log", {f"epi_neg_log_rows_{build}{t}": args
                                          for build in ("", "full_") for t in ("f32", "f64")})
    return _LIB


def _epi(fname, build, v, s, steps):
    x, t, (vp, sp, stride, value, xp, tp, rows, n), _keep = _rows.epi_args(fname, v, s)
    steps_ptr = _rows.steps_ptr(fname, steps, v)
    fn = getattr(_library(), f"epi_neg_log_rows_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (vp, sp, stride, value, xp, tp, steps_ptr, rows, n), x)
    return x, t


def epi_rows(v, s, steps=None):
    """The projection of every ``(v_row, s_row)`` onto
    ``{(x, t): -sum_i log x_i <= t}`` (CUDA, f32 or f64; the row along the
    last axis); ``s`` a number or a tensor broadcasting to the batch shape.
    Returns ``(x, t)``.  One launch."""
    return _epi("epi_neg_log", "", v, s, steps)


def epi_rows_full(v, s, steps=None):
    """:func:`epi_rows` by the full-count build (uncounted)."""
    return _epi("epi_neg_log full", "full_", v, s, steps)
