"""Timing and tracing of the port.

Counterpart of ``epsilon_tpu/utils/timing.py``.  One entry point marks the
port's layer boundaries: :class:`span` times a block on the host
(``time.perf_counter_ns``) and, while a ``torch.profiler`` records, opens a
user range there (what ``torch.profiler.record_function`` opens, with
arguments), so that the block shows on the profiler's clock beside the
device's activities.  :func:`count` adds to a
process-wide counter while a profiler records, and :func:`counters` reads
the totals.  :func:`profile_trace` records a Chrome trace of a block.

Spans: ``epsilon.solve`` (the root; its argument, the process's count of
solves, marks the spans of one solve), ``epsilon.compile``, ``epsilon.update_problem``,
``epsilon.solver_setup``, ``epsilon.factor`` (a ``BlockCholesky.factor``:
the host elimination, with each cached factor's LU or Cholesky and, where
the device applies it, its explicit inverse; its argument, the largest
pivot's dimension), ``epsilon.admm_loop``, ``epsilon.x_update``,
``epsilon.z_update``, ``epsilon.residuals``, ``epsilon.prox.<kind>`` and
``epsilon.write_back`` (:data:`PROX_SPANS` names the prox spans).
Counters: ``tv1d.calls`` and ``tv1d.rounds`` (the TV-1D PDAS prox, of
either version: K7 on the card, its plain version on the CPU), and
``tv1d.residue`` (those calls that launched K7 on a plan with the residue
stage); ``compile.folded_bytes`` (the host bytes of the constants that
the compiler folds into dense or sparse operators), and on a cached
solver's ``update_problem`` ``update.compared_bytes`` (the bytes of the
new problem's arrays compared with the old one's) and
``update.rebuilt_terms`` (the term operators built anew); ``admm.epochs``
(the loop's epochs), ``admm.graph_epochs`` (those a CUDA graph replayed)
and ``admm.graph_captures`` (the epochs captured), counted on the host
once an epoch.  None of them runs once an ADMM iteration.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from ..ir import ProxKind

# The span of a term's prox apply, by the term's kind
PROX_SPANS = {kind: f"epsilon.prox.{kind.value}" for kind in ProxKind}

# Private entry points of torch (their costs measured on torch 2.11; a
# tier-1 test runs them).  Whether a profiler records: one C++ flag read,
# no dispatcher call
_recording = torch._C._autograd._profiler_enabled
# record_function's user range, with its arguments kept as the range's
# inputs (a trace with record_shapes shows them), at a third of its cost
_open = torch._C._autograd._record_function_with_args_enter
_close = torch._C._autograd._record_function_with_args_exit
_now = time.perf_counter_ns

_host_counts: Dict[str, int] = {}
# The 0-d tensors counted on a device, kept as they are: counting launches
# nothing until _FOLD of them are held, which are then added up on the
# device into one
_device_counts: Dict[tuple, list] = {}
_FOLD = 4096


class span:
    """Time the block on the host, and mark it ``name`` in the trace of a
    profiler that records:

        with span("epsilon.compile") as t:
            ...
        t.ns, t.usec           # the block's host time

    ``args``, a tuple of numbers or strings, go to the profiler with the
    range.  With no profiler recording, a span costs a flag check and two
    clock reads."""

    __slots__ = ("name", "args", "ns", "_t0", "_range")

    def __init__(self, name: str, args: tuple = ()):
        self.name, self.args, self.ns = name, args, 0
        self._range = None

    def __enter__(self):
        if _recording():
            self._range = _open(self.name, *self.args)
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        self.ns = _now() - self._t0
        if self._range is not None:
            _close(self._range)
            self._range = None
        return False

    @property
    def usec(self) -> int:
        return self.ns // 1000


def count(name: str, n=1):
    """Add ``n`` to counter ``name`` while a profiler records (else do
    nothing).  ``n`` is a host int or a 0-d integer tensor, which stays on
    its device, unread: no host sync.  The tensor must not change
    afterwards (a kernel's fresh output).  Every ``_FOLD`` (4,096) tensors
    of one counter are added up into one, with a launch inside the window:
    a long profiled run pays that, a first use of the adding kernels
    included."""
    if not _recording():
        return
    if isinstance(n, torch.Tensor):
        held = _device_counts.setdefault((name, n.device), [])
        held.append(n)
        if len(held) >= _FOLD:
            held[:] = [_sum(held)]
    else:
        _host_counts[name] = _host_counts.get(name, 0) + int(n)


def _sum(held):
    return torch.stack(held).sum(dtype=torch.int64)


def counters() -> Dict[str, int]:
    """The counters' totals since the process started (or the last
    :func:`reset_counters`).  Adds up and reads the device counts, one
    host sync a device: call it after the window it counts."""
    out = dict(_host_counts)
    by_device: Dict[torch.device, list] = {}
    for (name, dev), held in _device_counts.items():
        by_device.setdefault(dev, []).append((name, _sum(held)))
    for pairs in by_device.values():
        values = torch.stack([total for _, total in pairs]).tolist()
        for (name, _), v in zip(pairs, values):
            out[name] = out.get(name, 0) + int(v)
    return out


def reset_counters():
    _host_counts.clear()
    _device_counts.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str = "epsilon_tpu_torch_trace"):
    """Capture a trace of everything inside the block (host operators, the
    port's spans, and the device's kernels when a CUDA device is in use):

        with profile_trace("trace_dir") as prof:
            solver.solve()

    On exit ``<log_dir>/trace.json`` holds a Chrome trace (open it at
    ``chrome://tracing`` or in Perfetto); the block's value is the
    ``torch.profiler.profile`` object, whose ``key_averages()`` are valid
    after the block."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
