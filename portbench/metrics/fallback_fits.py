"""fallback_fits: fits of the window whose guard report names a rung
other than the native one."""


def read(run):
    return run.counters["fallback_fits"]
