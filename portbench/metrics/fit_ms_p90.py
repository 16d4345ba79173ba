"""fit_ms_p90: the 90th percentile of the window's fit times (host
clock, reset to answer on the host), in ms."""

import statistics


def read(run):
    if len(run.fit_s) < 2:
        return None
    return statistics.quantiles(run.fit_s, n=10)[-1] * 1e3
