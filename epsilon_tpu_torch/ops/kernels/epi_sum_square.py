"""The SUM_SQUARE epigraph per row as one kernel launch
(``csrc/epi_sum_square.cu``).

The JAX package compiles ``_epi_sum_square`` (``epsilon_tpu/ops/prox/registry.py``),
its 40-step widening and 25-step safeguarded Newton (``lax.fori_loop``s)
included, into one device program per call.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.registry._epi_sum_square_reference`)
issues every loop step as eager operations; the kernel runs one row in one
block.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/registry.py``.
"""

from __future__ import annotations

import ctypes

from . import _rows

__all__ = ["epi_rows", "build", "launches"]

# Kernel launches made by epi_rows.
launches = 0

_LIB = None


def build():
    """Compile ``csrc/epi_sum_square.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("epi_sum_square")


def _library():
    global _LIB
    if _LIB is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        args = [P, P, I, "scalar", P, P, I, I, P]
        _LIB = _rows.load("epi_sum_square", {f"epi_sum_square_rows_{t}": args for t in ("f32", "f64")})
    return _LIB


def epi_rows(v, s):
    """The projection of every ``(v_row, s_row)`` onto
    ``{(x, t): ||x||^2 <= t}`` (CUDA, f32 or f64; the row along the
    last axis); ``s`` a number or a tensor broadcasting to the batch shape.
    Returns ``(x, t)``.  One launch."""
    x, t, args, _keep = _rows.epi_args("epi_sum_square", v, s)
    fn = getattr(_library(), f"epi_sum_square_rows_{_rows.suffix(x)}")
    global launches
    launches += 1
    _rows.launch("epi_sum_square", fn, args, x)
    return x, t
