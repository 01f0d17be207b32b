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
``ops/prox/vector.py`` and ``ops/prox/newton_epi.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox_rows", "epi_rows", "build", "prox_launches", "epi_launches"]

# Kernel launches made by prox_rows and epi_rows.
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
        prox = [_P, _P, _I, "scalar", _P, _I, _I, _P]
        epi = [_P, _P, _I, "scalar", _P, _P, _I, _I, _P]
        _LIB = _rows.load("lse_rows", {
            "lse_prox_rows_f32": prox, "lse_prox_rows_f64": prox,
            "lse_epi_rows_f32": epi, "lse_epi_rows_f64": epi})
    return _LIB


def prox_rows(v, lam):
    """``prox_{lam LSE}`` of every row of ``v`` (CUDA, f32 or f64; the row
    along the last axis); ``lam`` a number or a tensor of the batch shape
    (or broadcasting to it).  One launch."""
    v, batch, rows, n = _rows.rows_of("lse prox_rows", v)
    ptr, stride, value, _keep, _ = _rows.row_scalar("lse prox_rows", "lam", lam, v, batch)
    x = torch.empty_like(v)
    fn = getattr(_library(), f"lse_prox_rows_{_rows.suffix(v)}")
    global prox_launches
    prox_launches += 1
    _rows.launch("lse prox_rows", fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), rows, n), v)
    return x


def epi_rows(v, s):
    """The projection of every ``(v_row, s_row)`` onto
    ``{(x, t): logsumexp(x) <= t}`` (CUDA, f32 or f64); ``s`` a number or a
    tensor broadcasting to the batch shape.  Returns ``(x, t)``.  One
    launch."""
    x, t, args, _keep = _rows.epi_args("lse epi_rows", v, s)
    fn = getattr(_library(), f"lse_epi_rows_{_rows.suffix(x)}")
    global epi_launches
    epi_launches += 1
    _rows.launch("lse epi_rows", fn, args, x)
    return x, t
