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
``ops/prox/elementwise.py``.
"""

from __future__ import annotations

import ctypes

from . import _rows

__all__ = ["epi_rows", "build", "launches"]

# Kernel launches made by epi_rows.
launches = 0

_LIB = None


def build():
    """Compile ``csrc/epi_neg_log.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("epi_neg_log")


def _library():
    global _LIB
    if _LIB is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        args = [P, P, I, "scalar", P, P, I, I, P]
        _LIB = _rows.load("epi_neg_log", {f"epi_neg_log_rows_{t}": args for t in ("f32", "f64")})
    return _LIB


def epi_rows(v, s):
    """The projection of every ``(v_row, s_row)`` onto
    ``{(x, t): -sum_i log x_i <= t}`` (CUDA, f32 or f64; the row along the
    last axis); ``s`` a number or a tensor broadcasting to the batch shape.
    Returns ``(x, t)``.  One launch."""
    x, t, args, _keep = _rows.epi_args("epi_neg_log", v, s)
    fn = getattr(_library(), f"epi_neg_log_rows_{_rows.suffix(x)}")
    global launches
    launches += 1
    _rows.launch("epi_neg_log", fn, args, x)
    return x, t
