"""Faults planted under the timed path, and the precision control, for the
readings that the check's limits are set from (:mod:`portbench.readings`)
and for the tests that see ``correct`` come out false.

Each fault wraps the program's write-back of its answer,
``epsilon_tpu_torch.frontend.solve._set_solution``, through ``patch(obj,
name, value)`` (pytest's ``monkeypatch.setattr``, or :func:`setattr`).
The faults a solve can have are these two: the cells run one problem a
request (no batch to halve) on one chip (no exchange to leave out).
"""

from __future__ import annotations

import importlib

import numpy as np


def _solve_module():
    return importlib.import_module("epsilon_tpu_torch.frontend.solve")


def state_unchanged(patch):
    """A step that returns its state unchanged: after the first solve the
    program no longer writes its answer into the variables."""
    mod = _solve_module()
    original, calls = mod._set_solution, [0]

    def stale(problem, values, prox_problem):
        calls[0] += 1
        if calls[0] == 1:
            original(problem, values, prox_problem)

    patch(mod, "_set_solution", stale)


def answer_altered(patch):
    """An answer altered where it is produced: the largest element of every
    answer doubled."""
    mod = _solve_module()
    original = mod._set_solution

    def altered(problem, values, prox_problem):
        original(problem, values, prox_problem)
        found = {}
        mod.api.expr_var_objects(problem.objective.expr, found)
        for var in found.values():
            if var.value is not None and not var.attr.get("is_parameter"):
                a = var.value
                a[np.unravel_index(np.argmax(np.abs(a)), a.shape)] *= 2.0

    patch(mod, "_set_solution", altered)


def program_tf32(patch):
    """The control of a configuration whose program runs float32 with TF32
    off: the program with its TF32 path switched on (the port's ``config``
    turns TF32 off when it is imported; this turns it back on)."""
    import torch

    import epsilon_tpu_torch  # noqa: F401  (its config turns TF32 off when first imported)
    patch(torch.backends.cuda.matmul, "allow_tf32", True)
    patch(torch.backends.cudnn, "allow_tf32", True)


FAULTS = {"state_unchanged": state_unchanged, "answer_altered": answer_altered}
# the controls that run the program itself; a ``reference_*`` control puts
# the reference in its place (:func:`portbench.readings.control_from_reference`)
CONTROLS = {"program_tf32": program_tf32}
