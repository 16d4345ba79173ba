"""kernel_builds: nvcc processes the run started (the port's
``ops/_cuda_build.py::NVCC_RUNS`` at the end of set-up): 0 in every run
but a checkout's first, whose ``setup_s`` then holds the build."""


def read(run):
    return run.kernel_builds
