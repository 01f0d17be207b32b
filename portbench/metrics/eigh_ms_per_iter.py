"""Device time of ``torch.linalg.eigh`` (cuSOLVER), ms an ADMM iteration of
the profiled requests: the device's busy time while the host was inside
``aten::linalg_eigh``, which returns only once its kernels have run."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    seconds, calls = run.trace.busy_during_s("aten::linalg_eigh")
    iters = sum(r.iterations for r in run.traced)
    return 1e3 * seconds / iters if seconds > 0 and iters else None
