"""setup_s: process start to the first timed fit (host clock): imports,
input simulation, model build, kernel builds, the first capture and the
warm-up fits."""


def read(run):
    return run.setup_s
