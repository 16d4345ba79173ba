"""kernels_per_step: kernels the step programs' graph launches ran in the
traced fits (fill and elementwise kernels counted; the graphs' memcpy
and memset nodes left out) per step-program replay."""


def read(run):
    tr = run.trace
    if tr is None or tr.replays == 0 or not tr.graph_kernels:
        return None
    return len(tr.graph_kernels) / tr.replays
