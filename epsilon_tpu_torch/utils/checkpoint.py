"""Solver-state checkpoint/resume (elastic recovery).

Counterpart of ``epsilon_tpu/utils/checkpoint.py``: durable checkpoints of
the ADMM loop state (``(z, u[, rho][, kstates])`` / ``(u, ys)``), so a
killed solve resumes from the last saved epoch instead of iteration 0.

Usage::

    ckpt = SolverCheckpointer("/path/dir", every_epochs=50)
    solver.attach_checkpointer(ckpt)      # host drive saves periodically
    solver.solve()                        # resumes automatically if a
                                          # checkpoint exists

A checkpoint is one file, ``step_<iterations>.pt``: the state's leaves as
CPU tensors (``torch.save``) beside the state's fingerprint, written under
a temporary name and renamed, so a reader never sees half a file; ``keep``
bounds how many stay.  A restored state is moved to the configured device.

A solver sharded over a process group saves its state in the global layout
(``ProxADMMTwoBlockSolver.global_state``) from rank 0 alone, and every rank
reads the same file back (``check`` on rank 0, ``load`` everywhere): the
JAX package's elastic recovery, which also resumes at another world size.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
from typing import List, Optional

import torch

from .. import config
from ..ops.block import BlockVector

__all__ = ["SolverCheckpointer"]

logger = logging.getLogger("epsilon_tpu_torch")

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _flatten(state, path: str, leaves: List, desc: List[str]):
    """Leaves of a loop state in a fixed order, and a description of its
    structure: ``BlockVector`` blocks by sorted key (the key names go into
    the description), tuples by position, ``None`` as a marker with no
    leaf."""
    if isinstance(state, BlockVector):
        for k in sorted(state.keys()):
            _flatten(state[k], f"{path}/{k}", leaves, desc)
    elif isinstance(state, (tuple, list)):
        desc.append(f"{path}(")
        for i, s in enumerate(state):
            _flatten(s, f"{path}.{i}", leaves, desc)
        desc.append(")")
    elif state is None:
        desc.append(f"{path}:none")
    else:
        leaves.append(state)
        desc.append(f"{path}:{tuple(state.shape)}:{state.dtype}")


def _unflatten(like, leaves):
    """The structure of ``like`` filled from the iterator ``leaves``."""
    if isinstance(like, BlockVector):
        vals = {k: next(leaves) for k in sorted(like.keys())}
        return BlockVector({k: vals[k] for k in like.keys()})
    if isinstance(like, (tuple, list)):
        return tuple(_unflatten(s, leaves) for s in like)
    if like is None:
        return None
    return next(leaves)


def _state_fingerprint(state) -> str:
    """Identity of the problem behind a solver state: its structure (which
    for ``BlockVector`` leaves includes the variable and constraint key
    names) with every leaf's shape and dtype, hashed.  Refuses to resume a
    checkpoint of *another* problem whose leaves happen to have the same
    shapes."""
    leaves, desc = [], []
    _flatten(state, "", leaves, desc)
    return hashlib.sha256("|".join(desc).encode()).hexdigest()


class SolverCheckpointer:
    """Periodic checkpointing of a solver's loop state."""

    def __init__(self, directory: str, every_epochs: int = 10,
                 keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.every_epochs = every_epochs
        self.keep = keep
        self._count = 0
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    # -- saving --------------------------------------------------------------
    def tick(self) -> bool:
        """Count one epoch; True when an ``every_epochs`` boundary is
        crossed (a save is due)."""
        self._count += 1
        return self._count % self.every_epochs == 0

    def maybe_save(self, step: int, state) -> bool:
        """Save if an ``every_epochs`` boundary was crossed; returns whether
        a save happened.  ``step`` is the solver's iteration count."""
        if not self.tick():
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state) -> None:
        leaves, desc = [], []
        _flatten(state, "", leaves, desc)
        payload = {"leaves": [l.detach().cpu() for l in leaves],
                   "fingerprint": _state_fingerprint(state)}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self.keep]:
            os.remove(self._path(old))

    # -- restoring -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _read(self, step: int):
        out = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return out["leaves"], out["fingerprint"]

    def check(self, like_state) -> Optional[int]:
        """The latest step whose checkpoint restores into the structure of
        ``like_state``, or None when there is none, it cannot be read, it
        belongs to a different problem (state fingerprint) or its leaves'
        shapes differ (start fresh rather than resume wrongly)."""
        step = self.latest_step()
        if step is None:
            return None
        like_leaves, desc = [], []
        _flatten(like_state, "", like_leaves, desc)
        try:
            leaves, fp = self._read(step)
        except Exception as e:
            logger.warning(
                "checkpoint restore from %s step %s failed (%s: %s); "
                "starting from iteration 0", self.directory, step,
                type(e).__name__, e)
            return None
        if fp != _state_fingerprint(like_state):
            logger.warning(
                "checkpoint at %s step %s belongs to a different problem "
                "(state fingerprint mismatch); starting from iteration 0",
                self.directory, step)
            return None
        if len(leaves) != len(like_leaves) or any(
                a.shape != b.shape for a, b in zip(leaves, like_leaves)):
            logger.warning(
                "checkpoint at %s step %s has mismatched leaf shapes; "
                "starting from iteration 0", self.directory, step)
            return None
        return step

    def load(self, step: int, like_state, device=None):
        """The checkpoint of ``step`` (which :meth:`check` passed) in the
        structure and dtypes of ``like_state``, on ``device`` (the host
        when None)."""
        like_leaves, desc = [], []
        _flatten(like_state, "", like_leaves, desc)
        leaves, _ = self._read(step)
        return _unflatten(like_state, iter(
            [a.to(device=device or "cpu", dtype=b.dtype)
             for a, b in zip(leaves, like_leaves)]))

    def restore(self, like_state):
        """Restore the latest checkpoint into the structure of
        ``like_state`` (a freshly initialized solver state), on the
        configured device.  Returns ``(state, step)``, or ``(None, 0)`` when
        :meth:`check` finds nothing to restore."""
        step = self.check(like_state)
        if step is None:
            return None, 0
        return self.load(step, like_state, config.device()), int(step)

    def close(self):
        """Nothing is held open between calls; kept for the interface."""
