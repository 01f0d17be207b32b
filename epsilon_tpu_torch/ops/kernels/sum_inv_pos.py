"""The SUM_INV_POS prox as one kernel launch (``csrc/sum_inv_pos.cu``):
``x^2 (x - v) = lam``, the largest real root, for every element, one
thread an element.

The JAX package compiles ``prox_sum_inv_pos``
(``epsilon_tpu/ops/prox/elementwise.py``), its 40-step widening of the
bracket (a ``lax.fori_loop``) and its 50-step safeguarded Newton
(``util.newton_safeguarded``) included, into one device program per call.
The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_inv_pos_reference`)
issues every step as eager operations.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's widening stops at its first step
that leaves the bracket's end unchanged, which gives the full-count result
bitwise, and its Newton runs its count (an exit there measured slower:
the source's note); :func:`prox_full` launches the build that runs both
loops to their counts, the reference the widening's exit is checked
against (no dispatch calls it).  ``steps``, where
given, receives each element's widening and Newton steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox", "prox_full", "build", "entries", "launches", "WIDEN_STEPS", "NEWTON_STEPS"]

# Kernel launches made by prox (the full-count build's are not counted).
launches = 0

# The loops' counts (the JAX package's): the bracket's widening, then the
# safeguarded Newton.
WIDEN_STEPS = 40
NEWTON_STEPS = 50

_LIB = None


def build():
    """Compile ``csrc/sum_inv_pos.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("sum_inv_pos")


def entries():
    """The C entries of ``csrc/sum_inv_pos.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {f"sum_inv_pos_prox_{build}{t}": [P, P, I, "scalar", P, P, L, P]
            for build in ("", "full_") for t in ("f32", "f64")}


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("sum_inv_pos", entries())
    return _LIB


def _prox(fname, build, v, lam, steps):
    v, ptr, stride, value, _keep = _rows.element_args(fname, "lam", v, lam)
    x = torch.empty_like(v)
    steps_ptr = _rows.element_steps_ptr(fname, steps, tuple(x.shape) + (2,), x.device)
    fn = getattr(_library(), f"sum_inv_pos_prox_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), steps_ptr,
                             x.numel()), x)
    return x


def prox(v, lam, steps=None):
    """``x`` with ``x^2 (x - v) = lam`` elementwise (CUDA, f32 or f64);
    ``lam`` a number, a one-element tensor (on the card it is read there,
    never on the host) or a tensor broadcasting with v.  ``steps``, an int32
    tensor of the joint shape + ``(2,)``, receives each element's widening
    and Newton steps.  One launch."""
    return _prox("sum_inv_pos", "", v, lam, steps)


def prox_full(v, lam, steps=None):
    """:func:`prox` by the full-count build (uncounted)."""
    return _prox("sum_inv_pos full", "full_", v, lam, steps)

