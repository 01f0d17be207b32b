"""The 95th percentile of the latency of every request of the window, ms:
from the hand-over of the request's data to ``solve``'s return with the
values on the host."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return 1e3 * float(np.percentile([r.seconds for r in run.requests], 95))
