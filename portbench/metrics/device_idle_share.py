"""device_idle_share: the share of the untraced window in which the
device ran nothing, in %.  The device time of a fit is the union of the
device operations of the traced fits (device timestamps, which the
profiler's own host work does not lengthen) over their number; the
window's completed fits times that, over the window's length (host
clock), is its busy share.  The traced fits' own idle share is not
used: the profiler lengthens a fit's host work by about a quarter."""


def read(run):
    tr = run.trace
    if tr is None or tr.fits == 0 or tr.busy_s <= 0 or run.window_s <= 0:
        return None
    done = run.counters["fits"] - run.counters["failed"]
    busy = tr.busy_s / tr.fits * done
    return 100.0 * (1.0 - busy / run.window_s)
