"""factor_roofline: the dense step's float32 factor, n^3 / 3 at the
float32 peak (``portbench/roofline.py::factor_bound_s``), over the
profiler's time of its kernels in the step programs' graphs per
replay, in %."""

from portbench import roofline

#: the kernels of ``torch.linalg.cholesky_ex`` on an 8192 x 8192 float32
#: matrix as the profiler prints them on the H100 (cuSOLVER's blocked
#: factor: the diagonal blocks by getrf without pivoting, the trailing
#: update by syrk and one sgemm, the info kernel, and the upper triangle
#: zeroed); the normal equations' small float32 factor runs the same
#: getrf and triangle kernels, so its time is counted too
FACTOR_KERNELS = ("getrf_wo_pivot", "xmma_syrk_l_f32f32",
                  "cutlass_80_simt_sgemm_128x256_8x4_nt", "xxtrf4_set_info",
                  "triu_tril_kernel<float")


def read(run):
    tr = run.trace
    if tr is None or tr.replays == 0 or not run.full_cov:
        return None
    t = sum(b - a for name, a, b in tr.graph_kernels
            if any(k in name for k in FACTOR_KERNELS))
    if t <= 0:
        return None
    return 100.0 * roofline.factor_bound_s(run.shape["n"]) \
        / (t / tr.replays)
