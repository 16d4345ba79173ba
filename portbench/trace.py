"""The traced fits: a profiler wrapper that needs the card, and the
reduction of its device trace to intervals, busy time and breakdowns.

``trace_fits`` runs a few fits after the measured window under
``torch.profiler`` (CPU and CUDA activities), each fit inside a
``portbench.fit`` span and its start inside ``portbench.reset``, so the
idle gaps can be named by what the host was doing.  The device
operations that a ``cudaGraphLaunch`` started (the profiler gives each
the correlation id of the launch) are the step programs' own: the
step's device time and kernel count are read from those alone, so the
reset's commit, the covariance's copies and other work between replays
stay out of them.  Without a CUDA card it raises: a trace of the CPU
alone is no device trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
#: the host call whose correlation id marks a graph's device operations
GRAPH_LAUNCH = "cudaGraphLaunch"
#: the benchmark's own host spans (``portbench.fit``, ``.reset``, ...)
SPAN_PREFIX = "portbench."
_NAME_CHARS = 120


@dataclass
class Trace:
    #: device operations: (name, start s, end s), sorted by start
    ops: list = field(default_factory=list)
    #: the device operations the step programs' graph launches started
    graph_ops: list = field(default_factory=list)
    #: host spans: (name, start s, end s)
    host: list = field(default_factory=list)
    window_s: float = 0.0
    fits: int = 0
    replays: int = 0
    busy_s: float = 0.0
    #: the union of the graph launches' device operations
    graph_busy_s: float = 0.0

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if not o[0].startswith(_COPY_PREFIXES)]

    @property
    def graph_kernels(self) -> list:
        return [o for o in self.graph_ops
                if not o[0].startswith(_COPY_PREFIXES)]

    def intervals(self, ops=None):
        """The union of the device operations' intervals."""
        out = []
        for _, a, b in (self.ops if ops is None else ops):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def host_at(self, t: float) -> str:
        """The innermost host span around time t."""
        best = None
        for name, a, b in self.host:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0] if best else "host (no span)"

    def breakdown(self) -> dict:
        by_name = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        iv = self.intervals()
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {
            "device_ops": [[n[:_NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[self.host_at(0.5 * (a + b))[:_NAME_CHARS], b - a]
                          for a, b in gaps],
        }


def trace_fits(fit, nfits: int, counters) -> Trace:
    """Profile ``nfits`` calls of ``fit`` on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device trace needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    c0 = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nfits):
            with record_function("portbench.fit"):
                fit()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    c1 = counters()
    tr = Trace(window_s=window, fits=nfits,
               replays=c1["replays"] - c0["replays"])
    reduce_events(tr, prof.events(), DeviceType.CUDA)
    return tr


def reduce_events(tr: Trace, events, device) -> Trace:
    """Fill ``tr`` from the profiler's events (``name``, ``id``,
    ``device_type``, ``time_range`` in us): host spans, device
    operations, those of graph launches, and the busy times."""
    launches = set()
    device_ops = []
    for e in events:
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type != device:
            tr.host.append(span)
            if e.name == GRAPH_LAUNCH:
                launches.add(e.id)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN_PREFIX)):
            # a span's image on the device timeline is no device work
            device_ops.append((span, e.id))
    for span, corr in device_ops:
        tr.ops.append(span)
        if corr in launches:
            tr.graph_ops.append(span)
    tr.ops.sort(key=lambda o: o[1])
    tr.graph_ops.sort(key=lambda o: o[1])
    tr.busy_s = sum(b - a for a, b in tr.intervals())
    tr.graph_busy_s = sum(b - a for a, b in tr.intervals(tr.graph_ops))
    return tr
