"""step_mfu: the step's counted linear-algebra operations
(``portbench/roofline.py::step_flops``: the joint Gram, the Woodbury
tail and normal equations, or the dense step's covariance, factor and
solves) over the device time of one step's graphs (``step_device_ms``)
and over the 67 TFLOP/s float64 tensor-core peak, in %.  The
double-double Jacobian is not counted, so this is a lower bound."""

from portbench import roofline


def read(run):
    tr = run.trace
    if tr is None or tr.replays == 0 or tr.graph_busy_s <= 0:
        return None
    step_s = tr.graph_busy_s / tr.replays
    return 100.0 * roofline.step_flops(run.shape, run.full_cov) / step_s \
        / roofline.F64_TENSOR_FLOPS
