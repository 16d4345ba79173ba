"""step_device_ms: device time of the step programs' graphs (the union
of the device operations that a ``cudaGraphLaunch`` of the traced fits
started, matched by the profiler's correlation id) per step-program
replay, in ms.  The reset's commit, the input and output copies and the
covariance's transfer between replays are left out."""


def read(run):
    tr = run.trace
    if tr is None or tr.replays == 0 or tr.graph_busy_s <= 0:
        return None
    return tr.graph_busy_s / tr.replays * 1e3
