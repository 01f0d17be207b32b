"""Host time of the solver's factorizations, ms a profiled solver set-up:
the summed length of the program's ``epsilon.factor`` spans (each a
``BlockCholesky.factor``: the host elimination of a KKT system, its LU or
Cholesky and, on the card, its explicit inverse) over the number of its
``epsilon.solver_setup`` spans.  A program without the span reads as
nothing."""

from portbench.program_spans import spans


def read(run):
    if run.trace is None:
        return None
    factors, setups = spans(run.trace, "epsilon.factor"), spans(run.trace, "epsilon.solver_setup")
    if not factors or not setups:
        return None
    return sum(e.length for e in factors) / 1e3 / len(setups)
