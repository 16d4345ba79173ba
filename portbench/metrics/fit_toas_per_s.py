"""fit_toas_per_s: the TOAs of every fit completed in the window over
the window's elapsed time (host clock)."""


def read(run):
    done = run.counters["fits"] - run.counters["failed"]
    return done * run.ntoa / run.window_s
