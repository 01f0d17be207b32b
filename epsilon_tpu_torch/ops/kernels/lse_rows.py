"""LOG_SUM_EXP per row as one kernel launch: the prox and the epigraph
projection (``csrc/lse_rows.cu``).

The JAX package compiles ``prox_log_sum_exp`` and ``epi_log_sum_exp``
(``epsilon_tpu/ops/prox/vector.py``, ``newton_epi.py``), fixed-count
``lax.fori_loop``s included, into one device program per call.  The port's
plain versions (:func:`~epsilon_tpu_torch.ops.prox.vector.prox_log_sum_exp_reference`,
:func:`~epsilon_tpu_torch.ops.prox.newton_epi.epi_log_sum_exp_reference`)
issue every loop step as eager operations; the kernel runs one row's loops
in one warp.

These are the kernel entries: they take CUDA tensors only and raise on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/vector.py`` and ``ops/prox/newton_epi.py``.  The kernel's loops
stop once their state repeats, which gives the full-count result bitwise;
:func:`prox_rows_full` and :func:`epi_rows_full` launch the build that
runs every loop to its count, the reference that exit is checked against
(no dispatch calls them).  ``steps``, where given, receives each row's
step counts (``_rows.STEP_COUNTS``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox_rows", "epi_rows", "prox_rows_full", "epi_rows_full", "build",
           "prox_launches", "epi_launches"]

# Kernel launches made by prox_rows and epi_rows (the full-count builds'
# launches are not counted).
prox_launches = 0
epi_launches = 0

_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def build():
    """Compile ``csrc/lse_rows.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("lse_rows")


def _library():
    global _LIB
    if _LIB is None:
        prox = [_P, _P, _I, "scalar", _P, _P, _I, _I, _P]
        epi = [_P, _P, _I, "scalar", _P, _P, _P, _I, _I, _P]
        _LIB = _rows.load("lse_rows", {
            f"lse_{kind}_rows_{build}{t}": prox if kind == "prox" else epi
            for kind in ("prox", "epi") for build in ("", "full_") for t in ("f32", "f64")})
    return _LIB


def _prox(fname, build, v, lam, steps):
    v, batch, rows, n = _rows.rows_of(fname, v)
    ptr, stride, value, _keep, _ = _rows.row_scalar(fname, "lam", lam, v, batch)
    steps_ptr = _rows.steps_ptr(fname, steps, v)
    x = torch.empty_like(v)
    fn = getattr(_library(), f"lse_prox_rows_{build}{_rows.suffix(v)}")
    if not build:
        global prox_launches
        prox_launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), steps_ptr, rows, n),
                 v)
    return x


def _epi(fname, build, v, s, steps):
    x, t, (vp, sp, stride, value, xp, tp, rows, n), _keep = _rows.epi_args(fname, v, s)
    steps_ptr = _rows.steps_ptr(fname, steps, v)
    fn = getattr(_library(), f"lse_epi_rows_{build}{_rows.suffix(x)}")
    if not build:
        global epi_launches
        epi_launches += 1
    _rows.launch(fname, fn, (vp, sp, stride, value, xp, tp, steps_ptr, rows, n), x)
    return x, t


def prox_rows(v, lam, steps=None):
    """``prox_{lam LSE}`` of every row of ``v`` (CUDA, f32 or f64; the row
    along the last axis); ``lam`` a number or a tensor of the batch shape
    (or broadcasting to it).  One launch."""
    return _prox("lse prox_rows", "", v, lam, steps)


def epi_rows(v, s, steps=None):
    """The projection of every ``(v_row, s_row)`` onto
    ``{(x, t): logsumexp(x) <= t}`` (CUDA, f32 or f64); ``s`` a number or a
    tensor broadcasting to the batch shape.  Returns ``(x, t)``.  One
    launch."""
    return _epi("lse epi_rows", "", v, s, steps)


def prox_rows_full(v, lam, steps=None):
    """:func:`prox_rows` by the full-count build (uncounted)."""
    return _prox("lse prox_rows_full", "full_", v, lam, steps)


def epi_rows_full(v, s, steps=None):
    """:func:`epi_rows` by the full-count build (uncounted)."""
    return _epi("lse epi_rows_full", "full_", v, s, steps)
