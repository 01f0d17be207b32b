"""The EXP epigraph as one kernel launch (``csrc/epi_exp.cu``): the
projection of ``(v, s)`` onto ``{(x, t): e^x <= t}`` for every element, one
thread an element.

The JAX package compiles ``epi_exp`` (``epsilon_tpu/ops/prox/elementwise.py``),
its 40-step widening of the bracket (a ``lax.fori_loop``) and its 25-step
safeguarded Newton (``util.newton_safeguarded``) included, into one device
program per call.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.epi_exp_reference`)
issues every step as eager operations.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's widening stops at its first step
that leaves the bracket's end unchanged and its Newton once its state
repeats, which gives the full-count result bitwise; :func:`epi_full`
launches the build that runs both loops to their counts, the reference
those exits are checked against (no dispatch calls it).  ``steps``, where
given, receives each element's widening and Newton steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["epi", "epi_full", "build", "entries", "launches", "WIDEN_STEPS", "NEWTON_STEPS"]

# Kernel launches made by epi (the full-count build's are not counted).
launches = 0

# The loops' counts (the JAX package's): the bracket's widening, then the
# safeguarded Newton.
WIDEN_STEPS = 40
NEWTON_STEPS = 25

_LIB = None


def build():
    """Compile ``csrc/epi_exp.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("epi_exp")


def entries():
    """The C entries of ``csrc/epi_exp.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {f"epi_exp_{build}{t}": [P, P, I, "scalar", P, P, P, L, P]
            for build in ("", "full_") for t in ("f32", "f64")}


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("epi_exp", entries())
    return _LIB


def _epi(fname, build, v, s, steps):
    v, ptr, stride, value, _keep = _rows.element_args(fname, "s", v, s)
    x = torch.empty_like(v)
    t = torch.empty_like(v)
    steps_ptr = _rows.element_steps_ptr(fname, steps, tuple(x.shape) + (2,), x.device)
    fn = getattr(_library(), f"epi_exp_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), t.data_ptr(),
                             steps_ptr, x.numel()), x)
    return x, t


def epi(v, s, steps=None):
    """``(x, t)``, the projection of ``(v, s)`` onto ``{e^x <= t}``
    elementwise (CUDA, f32 or f64); ``s`` a number, a one-element tensor
    (on v's device it is read there, never on the host) or a tensor
    broadcasting with v (a stacked row's ``(rows, d)`` included).  ``steps``,
    an int32 tensor of the joint shape + ``(2,)``, receives each element's
    widening and Newton steps.  One launch."""
    return _epi("epi_exp", "", v, s, steps)


def epi_full(v, s, steps=None):
    """:func:`epi` by the full-count build (uncounted)."""
    return _epi("epi_exp full", "full_", v, s, steps)
