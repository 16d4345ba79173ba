"""replays_per_fit: step-program replays over the window (the fitter's
``ProgramCache.replays`` delta) per fit."""


def read(run):
    return run.counters["replays"] / run.counters["fits"]
