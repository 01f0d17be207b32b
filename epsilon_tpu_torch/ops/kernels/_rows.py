"""Argument handling shared by the per-row loop kernels (``lse_rows``,
``epi_sum_square``, ``epi_neg_log``) and the one-thread-an-element loop
kernels (``sum_logistic``, ``epi_exp``, ``sum_inv_pos``, ``w_log_w``:
:func:`element_args`; ``sum_kl_div``, two operands: :func:`element_args2`).

Each kernel takes a batch of rows (any leading shape, the row along the
last axis, flattened to ``rows x n``) and a per-row scalar (``lam`` or
``s``): a tensor on the rows' device, read by the kernel from device
memory (stride 0 broadcasts a single value, so a value that the solver
changes on the device needs no sync), or a host number passed by value.
Their loops stop when their state repeats, and they take an optional
``steps`` array, into which they write each row's step counts
(:func:`steps_ptr`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# The kernels repeat their plain versions' arithmetic operation by
# operation: no contracted multiply-adds where PyTorch rounds twice.  The
# optimizer runs on every core (lse_rows.cu holds 20 kernels: prox and
# epigraph per dtype, row in registers or not, with and without the exit,
# and the half-warp prox per dtype with and without it).
FLAGS = ("--fmad=false", "--split-compile=0")


def build(name: str, extra=(), csrc=None):
    """Compile ``csrc/<name>.cu`` with the ``extra`` nvcc flags (see
    :func:`._build.build`; ``csrc`` another tree's kernel sources)."""
    return _build.build(name, FLAGS + tuple(extra), csrc)


def load(name: str, entries, extra=(), csrc=None):
    """Load the library of ``csrc/<name>.cu`` (built with the ``extra``
    nvcc flags, from the directory ``csrc`` where given) and type its entry
    points: ``entries`` maps each C function to its argument types, where
    the string ``"scalar"`` stands for the entry's float type (``c_float``
    for a name ending in ``_f32``, else ``c_double``)."""
    path, _, _ = build(name, extra, csrc)
    lib = ctypes.CDLL(str(path))
    for fn_name, args in entries.items():
        scalar = ctypes.c_float if fn_name.endswith("_f32") else ctypes.c_double
        fn = getattr(lib, fn_name)
        fn.argtypes = [scalar if a == "scalar" else a for a in args]
        fn.restype = ctypes.c_int
    return lib


def broadcast_shape(*shapes):
    """The shapes' broadcast shape, by numpy's rule (torch's); raises
    ValueError where they do not broadcast.  ``torch.broadcast_shapes``
    imports sympy at its first call in a process: seconds on a fresh rank
    of phase 9, where this costs microseconds."""
    return tuple(int(d) for d in np.broadcast_shapes(*(tuple(sh) for sh in shapes)))


def rows_of(fname: str, v: torch.Tensor):
    """``(v contiguous, batch shape, rows, n)`` for a CUDA batch of rows;
    raises on another device, another dtype or an empty row."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{fname}: v must be a tensor, got {type(v).__name__}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fname}: v must be float32 or float64, got {v.dtype}")
    if v.dim() < 1 or v.shape[-1] < 1:
        raise ValueError(f"{fname}: v {tuple(v.shape)} needs rows of at least one element")
    if v.device.type != "cuda":
        raise ValueError(f"{fname}: the kernel needs a CUDA tensor, got one on {v.device}")
    batch = tuple(v.shape[:-1])
    n = v.shape[-1]
    rows = v.numel() // n
    if rows >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{fname}: v {tuple(v.shape)} is too large")
    return v.contiguous(), batch, rows, n


def row_scalar(fname: str, name: str, a, v: torch.Tensor, batch):
    """The per-row scalar ``a`` as ``(pointer or None, stride, value, keep,
    shape)``: a pointer into a tensor on v's device (``keep`` holds the
    tensor alive through the launch), or a host number by value; ``shape``
    is ``a``'s shape, for the output's broadcast shape."""
    if not isinstance(a, torch.Tensor):
        return None, 0, float(a), None, tuple(np.shape(a))
    shape = tuple(a.shape)
    if a.device.type == "cpu" and a.numel() == 1:
        return None, 0, float(a.reshape(())), None, shape
    if a.device != v.device:
        raise ValueError(f"{fname}: {name} on {a.device}, v on {v.device}")
    if a.dtype != v.dtype:
        a = a.to(v.dtype)
    if a.numel() == 1:
        return a.data_ptr(), 0, 0.0, a, shape
    try:
        a = torch.broadcast_to(a, batch).contiguous()
    except RuntimeError:
        raise ValueError(f"{fname}: {name} {shape} does not broadcast to the rows "
                         f"{tuple(batch)}") from None
    return a.data_ptr(), 1, 0.0, a, shape


def out_shape(fname: str, name: str, batch, shape):
    """The shape of a per-row output: the rows' batch shape broadcast with
    the scalar's (which must not add rows)."""
    try:
        out = broadcast_shape(batch, shape)
    except ValueError:
        raise ValueError(f"{fname}: {name} {tuple(shape)} does not broadcast to the rows "
                         f"{tuple(batch)}") from None
    if int(np.prod(out, dtype=np.int64)) != int(np.prod(batch, dtype=np.int64)):
        raise ValueError(f"{fname}: {name} {tuple(shape)} would add rows to {tuple(batch)}")
    return out


def epi_args(fname: str, v, s):
    """Check and allocate for an epigraph kernel over the rows of ``v``
    with bounds ``s``: returns ``(x, t, args, keep)``, ``args`` the C
    entry's arguments but the stream (``v, s, s_stride, s_value, x, t, rows,
    n``) and ``keep`` the tensors that must live through the launch."""
    v, batch, rows, n = rows_of(fname, v)
    ptr, stride, value, keep, s_shape = row_scalar(fname, "s", s, v, batch)
    x = torch.empty_like(v)
    t = torch.empty(out_shape(fname, "s", batch, s_shape), dtype=v.dtype, device=v.device)
    return x, t, (v.data_ptr(), ptr, stride, value, x.data_ptr(), t.data_ptr(), rows, n), (v, keep)


def _element_operands(fname: str, **operands):
    """Raise unless every operand is a float32 or float64 CUDA tensor (the
    types checked first)."""
    for label, v in operands.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{fname}: {label} must be a tensor, got {type(v).__name__}")
        if v.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{fname}: {label} must be float32 or float64, got {v.dtype}")
    for v in operands.values():
        if v.device.type != "cuda":
            raise ValueError(f"{fname}: the kernel needs a CUDA tensor, got one on {v.device}")


def element_args(fname: str, name: str, v, a):
    """Check the arguments of a one-thread-an-element kernel: ``v`` a CUDA
    tensor and ``a`` (``lam`` or ``s``) a number, a one-element CPU tensor
    (both passed by value), a one-element tensor on v's device (read there
    with stride 0, never on the host) or a tensor that broadcasts with v.
    Returns ``(v, pointer, stride, value, keep)``: v broadcast to the joint
    shape and contiguous, the pointer of ``a`` (None when passed by value)
    with its stride (0 or 1), its value, and the tensor that must live
    through the launch."""
    _element_operands(fname, v=v)
    ptr, stride, value, keep = None, 0, 0.0, None
    shape = tuple(v.shape)
    if isinstance(a, torch.Tensor) and not (a.device.type == "cpu" and a.numel() == 1):
        if a.device != v.device:
            raise ValueError(f"{fname}: {name} on {a.device}, v on {v.device}")
        try:
            shape = broadcast_shape(shape, a.shape)
        except ValueError:
            raise ValueError(f"{fname}: {name} {tuple(a.shape)} does not broadcast with v "
                             f"{tuple(v.shape)}") from None
        keep = a.to(v.dtype)
        if keep.numel() != 1:
            keep = torch.broadcast_to(keep, shape).contiguous()
            stride = 1
        ptr = keep.data_ptr()
    elif isinstance(a, torch.Tensor):
        shape = broadcast_shape(shape, a.shape)
        value = float(a.reshape(()))
    else:
        value = float(a)
    v = torch.broadcast_to(v, shape).contiguous()
    if v.numel() >= 2 ** 62:
        raise ValueError(f"{fname}: v {tuple(v.shape)} is too large")
    return v, ptr, stride, value, keep


def element_args2(fname: str, name: str, u, v, a):
    """The arguments of a one-thread-an-element kernel of two operands
    ``u`` and ``v`` (CUDA tensors of one dtype that broadcast together; the
    SUM_KL_DIV prox) and ``a`` as :func:`element_args` takes it.  Each
    tensor is taken as it comes where its elements lie as rows of the joint
    shape's last dimension with one row stride and a column stride of 1 or
    0 (a contiguous tensor, a row of a packed tensor such as ``z[...,
    :n]``, a row broadcast along the rows, a per-row ``lam`` of shape
    ``(rows, 1)``); any other layout is copied.  Returns ``(operands, n,
    shape, lam, keep)``: ``operands`` a ``(tensor, row stride, column
    stride)`` for u and for v, ``n`` the joint shape's row length,
    ``shape`` the joint shape, ``lam`` the ``(pointer or None, row stride,
    column stride, value)`` of ``a`` (a pointer with strides 0 for a
    one-element tensor on the card, None for a number passed by value) and
    ``keep`` the tensors that must live through the launch."""
    _element_operands(fname, u=u, v=v)
    if u.dtype != v.dtype or u.device != v.device:
        raise ValueError(f"{fname}: u ({u.dtype} on {u.device}) and v ({v.dtype} on "
                         f"{v.device}) differ")
    on_card = isinstance(a, torch.Tensor) and not (a.device.type == "cpu" and a.numel() == 1)
    if on_card and a.device != v.device:
        raise ValueError(f"{fname}: {name} on {a.device}, v on {v.device}")
    shapes = [tuple(u.shape), tuple(v.shape)] + ([tuple(a.shape)] if isinstance(a, torch.Tensor)
                                                 else [])
    try:
        shape = broadcast_shape(*shapes)
    except ValueError:
        raise ValueError(f"{fname}: u {tuple(u.shape)}, v {tuple(v.shape)} and {name} "
                         f"{tuple(np.shape(a))} do not broadcast") from None
    if int(np.prod(shape, dtype=np.int64)) >= 2 ** 62:
        raise ValueError(f"{fname}: the joint shape {shape} is too large")
    n = shape[-1] if shape else 1
    operands = tuple(_row_strided(torch.broadcast_to(t, shape), n) for t in (u, v))
    if not on_card:
        lam = (None, 0, 0, float(a.reshape(())) if isinstance(a, torch.Tensor) else float(a))
        return operands, n, shape, lam, operands
    a = a.to(v.dtype)
    if a.numel() == 1:
        return operands, n, shape, (a.data_ptr(), 0, 0, 0.0), operands + (a,)
    a, rs, cs = _row_strided(torch.broadcast_to(a, shape), n)
    return operands, n, shape, (a.data_ptr(), rs, cs, 0.0), operands + (a,)


def _row_strided(t: torch.Tensor, n: int):
    """``(t or a contiguous copy, row stride, column stride)``: element i
    of t's shape lies at ``(i // n) * row stride + (i % n) * column
    stride`` from its data pointer (strides n and 1: contiguous; a column
    stride of 0: one value a row)."""
    if t.is_contiguous():
        return t, n, 1
    if t.numel() > 0:
        try:
            rows = t.view(-1, n)
        except RuntimeError:
            rows = None
        if rows is not None and (n == 1 or rows.stride(1) in (0, 1)):
            return (t, rows.stride(0) if rows.shape[0] > 1 else 0,
                    rows.stride(1) if n > 1 else 1)
    return t.contiguous(), n, 1


def element_steps_ptr(fname: str, steps, shape, device):
    """The pointer of ``steps`` for a one-thread-an-element kernel's C
    entry (None for None): a contiguous int32 tensor of ``shape`` on
    ``device``, which the kernel fills."""
    if steps is None:
        return None
    if (not isinstance(steps, torch.Tensor) or steps.dtype != torch.int32
            or tuple(steps.shape) != tuple(shape) or not steps.is_contiguous()
            or steps.device != device):
        raise ValueError(f"{fname}: steps must be a contiguous int32 tensor of shape "
                         f"{tuple(shape)} on {device}")
    return steps.data_ptr()


# Step counts a row: epigraph Newton steps on lam, safeguarded Newton steps
# on nu (summed over the row's proxes), Lambert steps on the warp's chain
# (per pass the most any lane ran, summed over the passes but the bracket's
# lower end), Lambert steps of all elements (summed over every pass); a
# count a kernel has no loop for stays 0, and an inactive row counts 0.
# K4 (``epi_sum_square``) writes its safeguarded Newton steps on lam under
# "lam" and its widening steps under "nu".
STEP_COUNTS = ("lam", "nu", "lambert_chain", "lambert_elements")


def steps_ptr(fname: str, steps, v: torch.Tensor):
    """The pointer of ``steps`` for the C entry (None for None): a
    contiguous int32 tensor on v's device of shape ``v.shape[:-1] + (4,)``
    (:data:`STEP_COUNTS`), which the kernel fills."""
    if steps is None:
        return None
    want = tuple(v.shape[:-1]) + (len(STEP_COUNTS),)
    if (not isinstance(steps, torch.Tensor) or steps.dtype != torch.int32
            or tuple(steps.shape) != want or not steps.is_contiguous()
            or steps.device != v.device):
        raise ValueError(f"{fname}: steps must be a contiguous int32 tensor of shape {want} "
                         f"on {v.device}")
    return steps.data_ptr()


def suffix(t: torch.Tensor) -> str:
    """The C entry's type suffix for t's dtype."""
    return "f32" if t.dtype == torch.float32 else "f64"


def launch(fname: str, fn, args, t: torch.Tensor):
    """Call the C entry ``fn(*args, stream)`` on the current stream of t's
    device; raise if the launch failed (the entry returns
    ``cudaGetLastError()``)."""
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fname}: kernel launch failed with CUDA error {err}")
