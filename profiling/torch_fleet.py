"""Phase 18 of ``chip_smoke.py`` alone, on one CUDA card: the one-card
fleet — a stream's appends on bench.py's pulsar at 1e5 TOAs, the
cross-key fuse of three compositions' fit batches, an MCMC and a grid job
at 1e5 TOAs, and a kill and restart against a warm ledger — with every
gate and launch prediction of the phase.

    python3 profiling/torch_fleet.py [--out FILE] [--memory]

It builds the kernels first.  The JSON result goes to stdout's last line
and, with ``--out``, to FILE.  Phase 12's eager append, which
``chip_smoke.py`` prints beside the served one, is not run here: its
field (``stream.appends.phase12_eager``) is null.  ``--memory`` adds
what stays on the card after the phase, its garbage collected and the
allocator's cache emptied (``leftovers``): reserved and allocated bytes,
the reserved bytes split between the allocator's common pool and the
private pools of CUDA graphs, and the step programs, program caches,
engines, replicas and threads still alive, with the chain of objects
that holds each program cache.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import threading
import types
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _holders(obj, exclude, depth=8):
    """The chain of objects that holds ``obj``: at each level the first
    referrer that is not a frame or one of ``exclude`` (ids: this
    search's own lists), an object or a namespace before a bare list or
    tuple, as type names; a ``dict`` is shown as the object
    whose ``__dict__`` it is, and a module ends the chain."""
    chain, seen = [], set(exclude) | {id(obj)}
    for _ in range(depth):
        refs = [r for r in gc.get_referrers(obj)
                if id(r) not in seen and r is not chain
                and not isinstance(r, types.FrameType)]
        if not refs:
            break
        # an object or a namespace before a bare container
        refs.sort(key=lambda r: isinstance(r, (list, tuple)))
        obj = refs[0]
        seen.add(id(obj))
        if isinstance(obj, dict):
            owners = [o for o in gc.get_referrers(obj)
                      if getattr(o, "__dict__", None) is obj]
            if owners:
                obj = owners[0]
                seen.add(id(obj))
        if isinstance(obj, types.ModuleType):
            chain.append(f"module {obj.__name__}")
            break
        name = type(obj).__qualname__
        if isinstance(obj, (list, tuple, dict)):
            name += f"[{len(obj)}]"
        chain.append(name)
    return chain


def leftovers():
    """What phase 18 leaves on the card once it returned: see --memory."""
    from pint_tpu_torch.runtime.graphs import ProgramCache, StepProgram
    from pint_tpu_torch.serve import TimingEngine
    from pint_tpu_torch.serve.fabric.replica import Replica

    gc.collect()
    torch.cuda.empty_cache()
    pools = collections.Counter()
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        pools["common" if pool == (0, 0) else "graph"] += seg["total_size"]
    objs = gc.get_objects()
    progs = [o for o in objs if isinstance(o, StepProgram)]
    caches = [o for o in objs if isinstance(o, ProgramCache)]
    storages = {}
    for o in objs:
        if torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    mine = {id(objs), id(progs), id(caches)}

    def held(ts):
        return sum(t.untyped_storage().nbytes() for t in ts
                   if torch.is_tensor(t))

    out = dict(
        reserved=torch.cuda.memory_reserved(),
        allocated=torch.cuda.memory_allocated(),
        reserved_by_pool=dict(pools),
        cuda_tensors_seen=len(storages),
        cuda_tensor_bytes_seen=sum(storages.values()),
        step_programs=[dict(site=p.site, captured=p.captured,
                            pool_reserved=p.pool_reserved,
                            input_bytes=held(p.inputs),
                            output_bytes=held(p.outputs),
                            held_by=_holders(p, mine))
                       for p in progs],
        program_caches=[dict(keys=[repr(k)[:160] for k in c._programs],
                             captures=c.captures,
                             held_by=_holders(c, mine))
                        for c in caches],
        engines=sum(isinstance(o, TimingEngine) for o in objs),
        replicas=sum(isinstance(o, Replica) for o in objs),
        threads=sorted(t.name for t in threading.enumerate()),
    )
    del objs, progs, caches
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--memory", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fleet: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.build_libraries(cs.LIBRARIES)
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    out = cs.fleet_phase(torch.device("cuda"))
    if args.memory:
        out["leftovers"] = leftovers()
        cs.log(f"after phase 18: {out['leftovers']}")
    line = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
