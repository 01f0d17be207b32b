"""The SUM_LOGISTIC prox as one kernel launch (``csrc/sum_logistic.cu``):
``x + lam sigmoid(x) = v`` for every element, one thread an element.

The JAX package compiles ``prox_sum_logistic``
(``epsilon_tpu/ops/prox/elementwise.py``), its 40-step safeguarded Newton
(``util.newton_safeguarded``, a ``lax.fori_loop``) included, into one
device program per call.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_logistic_reference`)
issues every step as eager operations.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's loop stops once its state
repeats, which gives the full-count result bitwise; :func:`prox_full`
launches the build that runs the loop to its count, the reference that
exit is checked against (no dispatch calls it).  ``steps``, where given,
receives each element's Newton steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox", "prox_full", "build", "launches", "STEPS"]

# Kernel launches made by prox (the full-count build's are not counted).
launches = 0

# The safeguarded Newton's count (the JAX package's).
STEPS = 40

_LIB = None


def build():
    """Compile ``csrc/sum_logistic.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("sum_logistic")


def _library():
    global _LIB
    if _LIB is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = [P, P, I, "scalar", P, P, L, P]
        _LIB = _rows.load("sum_logistic", {f"sum_logistic_prox_{build}{t}": args
                                           for build in ("", "full_") for t in ("f32", "f64")})
    return _LIB


def _args(fname, v, lam):
    """``(v, x, lam pointer, stride, value, keep)``: v and lam broadcast
    to one shape, x allocated for it."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{fname}: v must be a tensor, got {type(v).__name__}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fname}: v must be float32 or float64, got {v.dtype}")
    if v.device.type != "cuda":
        raise ValueError(f"{fname}: the kernel needs a CUDA tensor, got one on {v.device}")
    ptr, stride, value, keep = None, 0, 0.0, None
    shape = tuple(v.shape)
    if isinstance(lam, torch.Tensor) and not (lam.device.type == "cpu" and lam.numel() == 1):
        if lam.device != v.device:
            raise ValueError(f"{fname}: lam on {lam.device}, v on {v.device}")
        try:
            shape = tuple(torch.broadcast_shapes(shape, tuple(lam.shape)))
        except RuntimeError:
            raise ValueError(f"{fname}: lam {tuple(lam.shape)} does not broadcast with v "
                             f"{tuple(v.shape)}") from None
        keep = lam.to(v.dtype)
        if keep.numel() != 1:
            keep = torch.broadcast_to(keep, shape).contiguous()
            stride = 1
        ptr = keep.data_ptr()
    elif isinstance(lam, torch.Tensor):
        shape = tuple(torch.broadcast_shapes(shape, tuple(lam.shape)))
        value = float(lam.reshape(()))
    else:
        value = float(lam)
    v = torch.broadcast_to(v, shape).contiguous()
    if v.numel() >= 2 ** 62:
        raise ValueError(f"{fname}: v {tuple(v.shape)} is too large")
    return v, torch.empty_like(v), ptr, stride, value, keep


def _prox(fname, build, v, lam, steps):
    v, x, ptr, stride, value, _keep = _args(fname, v, lam)
    steps_ptr = None
    if steps is not None:
        if (not isinstance(steps, torch.Tensor) or steps.dtype != torch.int32
                or tuple(steps.shape) != tuple(x.shape) or not steps.is_contiguous()
                or steps.device != x.device):
            raise ValueError(f"{fname}: steps must be a contiguous int32 tensor of shape "
                             f"{tuple(x.shape)} on {x.device}")
        steps_ptr = steps.data_ptr()
    fn = getattr(_library(), f"sum_logistic_prox_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), steps_ptr,
                             x.numel()), x)
    return x


def prox(v, lam, steps=None):
    """``x`` with ``x + lam sigmoid(x) = v`` elementwise (CUDA, f32 or f64);
    ``lam`` a number, a one-element tensor (on v's device it is read there,
    never on the host) or a tensor broadcasting with v.  One launch."""
    return _prox("sum_logistic", "", v, lam, steps)


def prox_full(v, lam, steps=None):
    """:func:`prox` by the full-count build (uncounted)."""
    return _prox("sum_logistic full", "full_", v, lam, steps)
