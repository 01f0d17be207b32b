"""K7's launches whose plan ran the residue-class stage (the PCR levels
after the tile stage in shared memory, class by class of the rows mod 2^K),
as a share of the TV-1D prox's calls, over the profiled requests: the
program's ``tv1d.residue`` over its ``tv1d.calls``
(``epsilon_tpu_torch.utils.timing``; the plain version on the CPU counts
0; a program that does not count ``tv1d.residue`` reads as nothing)."""


def read(run):
    try:
        from epsilon_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    totals = counters() if run.trace is not None else {}
    if not totals.get("tv1d.calls") or "tv1d.residue" not in totals:
        return None
    return totals["tv1d.residue"] / totals["tv1d.calls"]
