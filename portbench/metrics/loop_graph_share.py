"""The share of the ADMM loop's epochs that a CUDA graph replayed, over the
profiled requests: the program's ``admm.graph_epochs`` over its
``admm.epochs`` (``epsilon_tpu_torch.utils.timing``; 0 where no epoch was
replayed, as on the CPU; a program that does not count ``admm.epochs``
reads as nothing)."""


def read(run):
    try:
        from epsilon_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    totals = counters() if run.trace is not None else {}
    if not totals.get("admm.epochs"):
        return None
    return totals.get("admm.graph_epochs", 0) / totals["admm.epochs"]
