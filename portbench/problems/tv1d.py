"""1-D total-variation denoising: minimize 1/2 ||x - b||^2 + lam tv(x).

The instances are a pool of signals ``b`` (:func:`generators.tv1d_signals`);
the reference is the exact minimiser (:mod:`portbench.reference.tv1d`),
computed on the host in worker processes, one signal each.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..reference.tv1d import round_bf16, tv1d_exact
from . import generators


def generate(cfg, mix, rng):
    """The pool of signals.  Their intervals, shifts and noise come from the
    configuration's own seeds, so every run asks for the same work; the
    run's ``rng`` picks where the cycle starts and whether the signals are
    reversed and negated, which leave the solves' work unchanged."""
    n, count = int(cfg["n"]), int(mix["count"])
    signals = generators.tv1d_signals(n, count, np.random.default_rng(int(cfg["structure_seed"])),
                                      np.random.default_rng(int(cfg["noise_seed"])))
    start, reverse, negate = (int(rng.integers(count)), bool(rng.integers(2)),
                              bool(rng.integers(2)))
    signals = np.roll(signals, -start, axis=0)
    if reverse:
        signals = signals[:, ::-1]
    if negate:
        signals = -signals
    return {"signals": np.ascontiguousarray(signals), "lam": generators.tv1d_weight(n)}


def instances(cfg, mix, data):
    """The parameter values of each instance: one signal each."""
    return [{"b": row} for row in data["signals"]]


def build(ep, cfg, data, values, parametric):
    """The problem and its handles: ``params`` (name -> Parameter, when
    ``parametric``) and ``variable``."""
    n = int(cfg["n"])
    x = ep.Variable(n)
    b = ep.Parameter(n, 1, value=values["b"]) if parametric else values["b"]
    prob = ep.Problem(ep.Minimize(0.5 * ep.sum_squares(x - b) + data["lam"] * ep.tv(x)))
    return prob, ({"b": b} if parametric else {}), x


def answer(variable):
    return np.asarray(variable.value).ravel()


def references(cfg, data, values_list, control=False, device=None):
    """Each instance's exact minimiser, in float64 or, with ``control``,
    computed in bfloat16: one worker process an instance (the algorithm is
    sequential), started by spawn and stopped before this returns."""
    q = round_bf16 if control else None
    jobs = [(v["b"], data["lam"], q) for v in values_list]
    if len(jobs) <= 1:
        return [tv1d_exact(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(len(jobs), int(cfg["reference_workers"])),
                             mp_context=ctx) as pool:
        return list(pool.map(tv1d_exact, *zip(*jobs)))


def compare(cfg, data, values, got, ref):
    """The number compared for one answer: its distance from the exact
    minimiser relative to the minimiser's norm.  (Its largest elementwise
    gap is not compared: a jump that the solve places one sample off at
    rel_tol 1e-3 reads as the jump's height there.)"""
    if got is None or got.shape != ref.shape or not np.all(np.isfinite(got)):
        return {"rel_err": np.inf}
    got = got.astype(np.float64)
    return {"rel_err": float(np.linalg.norm(got - ref) / np.linalg.norm(ref))}
