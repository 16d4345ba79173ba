"""Step programs: a fit step captured once as CUDA graphs and replayed.

Counterpart of the reference's one-program chokepoint,
``pint_tpu/models/timing_model.py::CompiledModel.jit``, through which its
fit loops (``fitting/base.py::make_scan_fit_loop``, the fused downhill
loop, ``PTABatch``'s scan) run as single device programs.  Here a
:class:`StepProgram` turns a function of static-shape tensors into one:

- on ``cuda`` the first call warms the function up on a side stream (one
  eager call: the lazily built tables, the kernels' libraries, the
  library handles), captures it into ``torch.cuda.CUDAGraph``s (after
  emptying the allocator's cache where the free memory could not hold
  it again, ``CAPTURE_ROOM``: a capture that runs out of memory is
  invalidated) and replays them; every call copies its inputs into the
  static input buffers, replays, and returns copies of the static
  outputs, which the caller may keep across later replays;
- on ``cpu`` it calls the function directly.

A library call that checks its result on the host (``torch.linalg.eigh``
reads its ``info`` with ``.item()``) cannot be captured.  The step routes
it through :func:`host_call`, and the program splits there: the graph
before it, the call itself, eager, on the static tensors, then the graph
after it, both graphs in one memory pool.  A failed capture or replay
raises; nothing runs the step eagerly in its place.

The hand-written kernels' wrappers count their launches in Python as they
launch (``ops/_cuda_build.py::LAUNCH_COUNTERS``).  A capture launches
nothing: the counts it recorded are taken back and added again by each
replay of the graph that holds those launches, here and nowhere else.

Programs live in a :class:`ProgramCache`, one per compiled model
(``CompiledModel.program``) or PTA batch, keyed as the reference keys its
fit loops (step mode or rung, ``force_f64``, the shapes).
``CompiledModel.commit`` empties its cache: a graph reads the reference
tensors by address, and a commit replaces them.
"""

from __future__ import annotations

import threading
import time

import torch

from pint_tpu_torch.ops._cuda_build import LAUNCH_COUNTERS

_capturing = threading.local()

#: a capture starts with the allocator's cache emptied unless the card's
#: free memory is at least this many times the cache's unused bytes (an
#: upper bound of the warm-up's working set, which the capture's own pool
#: must hold again)
CAPTURE_ROOM = 1.5


def flatten(tree):
    """-> (tensor leaves, rebuild(leaves) -> tree) for trees of dicts,
    tuples, NamedTuples (TOABundle, DD), tensors and None: a step
    program's outputs, a PTA batch's state."""
    leaves = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return lambda it: next(it)
        if t is None:
            return lambda it: None
        if isinstance(t, dict):
            subs = {k: walk(v) for k, v in t.items()}
            return lambda it: {k: f(it) for k, f in subs.items()}
        if isinstance(t, tuple):
            subs = [walk(v) for v in t]
            make = (type(t)._make if hasattr(type(t), "_fields")
                    else tuple)
            return lambda it: make(f(it) for f in subs)
        raise TypeError(f"unexpected leaf {type(t).__name__} in a tree of "
                        "tensors")

    build = walk(tree)
    return leaves, lambda ls: build(iter(ls))


def _counts():
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _add_counts(delta, sign=1):
    for (fn, attr), d in zip(LAUNCH_COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + sign * d)


class _HostCall(torch.autograd.Function):
    """``op(*tensors)`` as one operation: eager, or a split point of the
    program being captured.  Its vmap rule moves the batch axis to the
    front and calls ``op`` once on the whole batch (``op`` treats leading
    dimensions as a batch, as the ``torch.linalg`` functions do), so a
    split inside ``torch.func.vmap`` happens on the physical tensors."""

    @staticmethod
    def forward(op, *ts):
        cap = getattr(_capturing, "program", None)
        if cap is None:
            return tuple(op(*ts))
        return cap._split(op, ts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, op, *ts):
        B = info.batch_size
        # in_dims[0] is op's (None)
        flat = [t.unsqueeze(0).expand(B, *t.shape) if d is None
                else t.movedim(d, 0) for t, d in zip(ts, in_dims[1:])]
        outs = _HostCall.apply(op, *flat)
        return outs, tuple(0 for _ in outs)


def host_call(op, *ts):
    """``tuple(op(*ts))``, where ``op`` checks its result on the host:
    eager outside a capture, the split point of a step program inside
    one."""
    return _HostCall.apply(op, *ts)


class _Segment:
    """One captured graph, the launch counts it holds, and the host call
    that follows it (None for the last segment)."""

    def __init__(self, graph, delta):
        self.graph = graph
        self.delta = delta
        self.op = None
        self.args = ()  # the call's inputs: tensors of the graph's pool
        self.outs = ()  # its static outputs, read by the next graph

    def replay(self):
        self.graph.replay()
        _add_counts(self.delta)
        if self.op is not None:
            for s, o in zip(self.outs, self.op(*self.args)):
                s.copy_(o)


class StepProgram:
    """A function of static-shape tensors run as captured CUDA graphs on
    the card and directly on the CPU.  ``fn`` is kept for the program's
    life: its closure holds tensors the graphs read by address.  The
    graphs' memory pool goes with the program."""

    def __init__(self, fn, device, stats=None):
        self.fn = fn
        self.device = torch.device(device)
        self.stats = stats  # a ProgramCache that adds up replays, captures
        self.segments: list[_Segment] = []
        self.inputs: list[torch.Tensor] = []
        self.outputs: list[torch.Tensor] = []
        self._rebuild = None
        self._pool = None
        self._stream = None
        self._open = None  # (graph, counts before) of the open segment
        self._prev_stream = None
        self.replays = 0
        self.capture_s: float | None = None
        #: device memory reserved during the capture: the pool's segments
        self.pool_reserved = 0

    @property
    def captured(self) -> bool:
        return bool(self.segments)

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        if not self.captured:
            self._capture(args)
        if len(args) != len(self.inputs):
            raise ValueError(f"step program captured with {len(self.inputs)} "
                             f"inputs, called with {len(args)}")
        for s, a in zip(self.inputs, args):
            if a.shape != s.shape or a.dtype != s.dtype:
                raise ValueError(
                    f"step program captured for {tuple(s.shape)} {s.dtype}, "
                    f"called with {tuple(a.shape)} {a.dtype}")
            if a is not s:
                s.copy_(a)
        for seg in self.segments:
            seg.replay()
        self.replays += 1
        if self.stats is not None:
            self.stats.replays += 1
        return self._rebuild([o.clone() for o in self.outputs])

    # -- capture ---------------------------------------------------------
    def _capture(self, args):
        if getattr(_capturing, "program", None) is not None:
            raise RuntimeError("a step program cannot capture inside "
                               "another's capture")
        t0 = time.perf_counter()
        dev = self.device
        main = torch.cuda.current_stream(dev)
        self._stream = torch.cuda.Stream(dev)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            self.fn(*args)  # warm-up: builds what the step builds lazily
        main.wait_stream(self._stream)
        self.inputs = [a.clone() for a in args]
        torch.cuda.synchronize(dev)
        # the graphs take their memory from a pool of their own, which
        # cannot reuse the cached blocks the warm-up left.  Running out of
        # memory inside a capture makes the allocator free its cache, and a
        # cudaFree there invalidates the capture; so where the card's free
        # memory would not hold the cache's size again with room to spare,
        # the cache is handed back first
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        if torch.cuda.mem_get_info(dev)[0] < CAPTURE_ROOM * cached:
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        _capturing.program = self
        self._pool = torch.cuda.graph_pool_handle()
        try:
            self._begin()
            out = self.fn(*self.inputs)
            self.outputs, self._rebuild = flatten(out)
            self._end()
        except BaseException:
            self._abort()
            raise
        finally:
            _capturing.program = None
        self.pool_reserved = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        if self.stats is not None:
            self.stats.captures += 1
            self.stats.capture_s += self.capture_s

    def _begin(self):
        """Start capturing the next segment on the side stream, in the
        program's one memory pool."""
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._prev_stream = torch.cuda.current_stream(self.device)
        torch.cuda.set_stream(self._stream)
        self._open = (graph, _counts())
        graph.capture_begin(pool=self._pool)

    def _end(self) -> _Segment:
        graph, before = self._open
        self._open = None
        try:
            graph.capture_end()
        finally:
            torch.cuda.set_stream(self._prev_stream)
        delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts(delta, -1)  # the capture launched nothing
        seg = _Segment(graph, delta)
        self.segments.append(seg)
        return seg

    def _abort(self):
        """Leave a failed capture: end it if it is open, forget every
        segment, take back the counts it recorded."""
        if self._open is not None:
            graph, before = self._open
            self._open = None
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # an invalidated capture raises here too
            finally:
                torch.cuda.set_stream(self._prev_stream)
            _add_counts([a - b for a, b in zip(_counts(), before)], -1)
        self.segments, self.inputs, self.outputs = [], [], []
        self._pool = None

    def _split(self, op, ts):
        """A host call inside the capture: end the segment, replay it so
        that ``ts`` hold this call's values, run ``op`` eagerly, keep its
        outputs in static buffers, and capture the rest as a new
        segment that reads them."""
        seg = self._end()
        seg.replay()
        outs = tuple(o.clone() for o in op(*ts))
        seg.op, seg.args, seg.outs = op, ts, outs
        self._begin()
        return outs


class ProgramCache:
    """The step programs of one compiled model or PTA batch, by key.
    ``captures``, ``replays`` and ``capture_s`` add up over the cache's
    life, across :meth:`clear`; ``pool_reserved`` is the device memory
    reserved by the captures of the programs it holds now."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._programs: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def program(self, fn, key) -> StepProgram:
        """The program cached under ``key``, made from ``fn`` if there is
        none."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = StepProgram(fn, self.device,
                                                     stats=self)
        return prog

    def clear(self):
        """Drop every program, and with it its graphs and memory pool."""
        self._programs.clear()

    def __len__(self):
        return len(self._programs)

    @property
    def pool_reserved(self) -> int:
        return sum(p.pool_reserved for p in self._programs.values())
