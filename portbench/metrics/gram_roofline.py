"""gram_roofline: the joint Gram kernel's bound over its time, in %.

Time: the profiler's kernels of ``csrc/fused_gram_wide.cu`` (wide_pass1,
wide_pass2) and ``csrc/fused_gram_joint.cu`` (fused_gram_pass1,
fused_gram_pass2) in the traced fits, per launch (per pass-1 kernel).
Bound: ``portbench/roofline.py::gram_bound_s`` of the cell's (n, k, p1).
"""

from portbench import roofline

PASS1 = ("wide_pass1", "fused_gram_pass1")
PASS2 = ("wide_pass2", "fused_gram_pass2")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = 0.0
    launches = 0
    for name, a, b in tr.kernels:
        if any(p in name for p in PASS1):
            launches += 1
            t += b - a
        elif any(p in name for p in PASS2):
            t += b - a
    if launches == 0 or t <= 0:
        return None
    s = run.shape
    return 100.0 * roofline.gram_bound_s(s["n"], s["k"], s["p1"]) \
        / (t / launches)
