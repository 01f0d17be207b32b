"""Solves completed a second: every request of the window over the window,
which runs from its start to the return of the last request issued before
its length had passed."""


def read(run):
    done = sum(1 for r in run.requests if r.ok)
    return done / run.window_s if run.window_s > 0 else None
