"""captures_in_window: step programs captured during the window (the
``ProgramCache.captures`` delta); 0 when set-up warmed everything."""


def read(run):
    return run.counters["captures"]
