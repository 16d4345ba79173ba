"""The roofline counts against the figures PERF.md keeps: the binary
MSP's joint Gram at (1e5, 60, 169) is 5.27e9 flop (bound 0.0786 ms, set
by its operations), BASELINE config 3's at (8192, 316, 119) is bound at
0.0232 ms, bench.py's (1e5, 60, 7) reads 54.4 MB.  The trace's reduction
counts a step's device time and kernels from its graph launches alone."""

from types import SimpleNamespace

import pytest

from portbench import roofline
from portbench.trace import Trace, reduce_events


def test_msp_gram_flops():
    assert roofline.gram_flops(100_000, 60, 169) == pytest.approx(5.27e9,
                                                                  rel=1e-3)
    assert roofline.gram_bound_s(100_000, 60, 169) == pytest.approx(
        0.0786e-3, rel=1e-3)


def test_config3_gram_bound():
    assert roofline.gram_bound_s(8192, 316, 119) == pytest.approx(
        0.0232e-3, rel=2e-3)


def test_bench_gram_is_bound_by_its_bytes():
    n, k, p1 = 100_000, 60, 7
    assert roofline.gram_bytes(n, k, p1) == pytest.approx(54.4e6, rel=1e-3)
    assert roofline.gram_bound_s(n, k, p1) == pytest.approx(
        54.4e6 / roofline.HBM_BYTES_PER_S, rel=1e-3)


def test_factor_bound_is_its_operations():
    n = 8192
    assert roofline.factor_bound_s(n) == pytest.approx(
        n ** 3 / 3 / 67e12, rel=1e-12)


@pytest.mark.parametrize("full_cov", [False, True])
def test_step_counts_hold_the_gram(full_cov):
    shape = {"n": 8192, "k": 316, "p1": 119}
    step = roofline.step_flops(shape, full_cov)
    assert step > roofline.gram_flops(8192, 316, 119) or full_cov
    if full_cov:
        assert step > roofline.factor_flops(8192)


def _event(name, corr, start_us, end_us, device):
    return SimpleNamespace(name=name, id=corr, device_type=device,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def test_trace_counts_graph_launches_alone():
    """Device operations whose correlation id is a ``cudaGraphLaunch``'s
    are the step's; a fill between replays is device work but no step
    work, and a user span's device image is neither."""
    host, dev = "cpu", "cuda"
    events = [
        _event("portbench.fit", 1, 0.0, 100.0, host),
        _event("cudaLaunchKernel", 7, 1.0, 2.0, host),
        _event("fill", 7, 3.0, 13.0, dev),
        _event("cudaGraphLaunch", 9, 20.0, 30.0, host),
        _event("gemm", 9, 31.0, 51.0, dev),
        _event("Memcpy DtoD", 9, 51.0, 52.0, dev),
        _event("add", 9, 52.0, 62.0, dev),
        _event("portbench.fit", 1, 31.0, 62.0, dev),
    ]
    tr = reduce_events(Trace(window_s=1e-4, fits=1, replays=1), events,
                       dev)
    assert [o[0] for o in tr.graph_kernels] == ["gemm", "add"]
    assert tr.graph_busy_s == pytest.approx(31e-6)
    assert tr.busy_s == pytest.approx(41e-6)
    assert len(tr.kernels) == 3
