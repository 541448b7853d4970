"""Spans, counters and the device trace of a ``--trace 1`` run.

The harness records its own spans around calls into the program's layers
(thin wrappers it installs on the objects it built; the program has no
spans of its own yet), snapshots the program's counters around the window,
and runs ``torch.profiler`` over a steady slice of it.  The slice's trace
gives the device's busy time, the time of each kernel, and the gaps in
which the device idled, named by the harness span the host was in.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import threading
import time


class Tracer:
    def __init__(self, enabled: bool, tmpdir: str):
        self.enabled = enabled
        self.tmpdir = tmpdir
        self.spans: list[tuple] = []          # (name, t0, t1, info)
        self._lock = threading.Lock()
        self.local = threading.local()
        self.prof = None
        self.slice = None                     # (t0, t1) host clock
        self.device = None                    # reduced profiler trace
        self.counters0 = self.counters1 = None
        self._annot = None

    def wrap(self, obj, attr: str, name: str, info=None, before=None) -> None:
        """Record a span around every call of ``obj.attr`` (an instance
        attribute shadows the method); ``info(args, kwargs, result)`` adds
        what a reader needs, ``before(args, kwargs)`` runs first."""
        if not self.enabled:
            return
        import torch

        orig = getattr(obj, attr)
        label = "ragbench." + name

        def wrapper(*a, **kw):
            if before is not None:
                before(a, kw)
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                res = orig(*a, **kw)
            t1 = time.perf_counter()
            extra = info(a, kw, res) if info is not None else None
            with self._lock:
                self.spans.append((name, t0, t1, extra))
            return res

        setattr(obj, attr, wrapper)

    def of(self, name: str) -> list[tuple]:
        return [s for s in self.spans if s[0] == name]

    # ------------------------------------------------------------ profiler
    @staticmethod
    def _profiler(sched=None):
        """A profiler of the card and of every host thread (the scheduler's
        workers and the request threads, not only the caller's)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:  # an older torch: the caller's thread only
            cfg = None
        return profile(activities=acts, schedule=sched,
                       experimental_config=cfg)

    def arm(self) -> None:
        """Start the profiler in set-up without recording (its first start
        takes seconds); ``start_profile`` then only switches recording on."""
        if not self.enabled:
            return
        from torch.profiler import schedule

        self.prof = self._profiler(schedule(wait=0, warmup=1, active=1))
        self.prof.start()

    def start_profile(self) -> None:
        """Record from now until ``stop_profile``."""
        if self.prof is None or self.slice is not None:
            return
        import torch

        self.prof.step()
        self._annot = torch.profiler.record_function("ragbench.slice")
        self._annot.__enter__()
        self.slice = (time.perf_counter(), None)

    def stop_profile(self) -> None:
        if self.slice is None or self.slice[1] is not None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.slice = (self.slice[0], time.perf_counter())
        self._annot.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> None:
        """Read the slice's trace: kernel intervals and host annotations."""
        if self.prof is None or self.slice is None or self.slice[1] is None:
            return
        path = os.path.join(self.tmpdir, "ragbench_trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        self.device = reduce_events(events, self.slice[1] - self.slice[0])


_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
#: which span names a gap first, most specific first
_PRIORITY = ("bm25", "embed", "scan", "add_texts", "batch", "round")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: list, window_s: float) -> dict:
    """Chrome-trace events → busy seconds, seconds by kernel name, and idle
    seconds by the harness span open on the host (µs in, seconds out)."""
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in _DEVICE_CATS]
    annots = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("ragbench.")]
    sl = [e for e in annots if e["name"] == "ragbench.slice"]
    if sl:
        lo, hi = float(sl[0]["ts"]), float(sl[0]["ts"]) + float(sl[0]["dur"])
    elif kernels:
        lo = min(float(e["ts"]) for e in kernels)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in kernels)
    else:
        lo = hi = 0.0
    by_name: dict[str, float] = collections.defaultdict(float)
    n_by_name: dict[str, int] = collections.defaultdict(int)
    ivs = []
    for e in kernels:
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        if t > s:
            ivs.append((s, t))
            by_name[str(e["name"])[:120]] += (t - s) / 1e6
            n_by_name[str(e["name"])[:120]] += 1
    merged = _merge(ivs)
    busy = sum(e - s for s, e in merged) / 1e6
    spans = collections.defaultdict(list)
    for e in annots:
        name = e["name"][len("ragbench."):]
        if name != "slice":
            spans[name].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    # per name: starts in order and the latest end among the spans so far,
    # so that "a span of this name is open at t" is one bisection
    open_at = {}
    for name, ivs_n in spans.items():
        ivs_n.sort()
        ends, top = [], float("-inf")
        for _, b in ivs_n:
            top = max(top, b)
            ends.append(top)
        open_at[name] = ([a for a, _ in ivs_n], ends)

    def is_open(name, t):
        if name not in open_at:
            return False
        starts, ends = open_at[name]
        i = bisect.bisect_right(starts, t)
        return i > 0 and ends[i - 1] >= t

    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        label = "no harness span"
        for name in _PRIORITY:
            if is_open(name, mid):
                label = name
                break
        gaps[label] += (e - s) / 1e6
    return {
        "busy_s": busy,
        "window_s": (hi - lo) / 1e6 if sl else window_s,
        "kernel_s": dict(by_name),
        "kernel_n": dict(n_by_name),
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, v] for n, v in gaps.items()),
                            key=lambda x: -x[1])[:10],
    }


@contextlib.contextmanager
def counters(tracer: Tracer, names: list[str]):
    """Snapshot the program's counters before and after the block."""
    from archi_tpu_torch.utils.metrics import METRICS

    tracer.counters0 = {n: METRICS.counter_value(n) for n in names}
    yield
    tracer.counters1 = {n: METRICS.counter_value(n) for n in names}


def counter_delta(tracer: Tracer, name: str) -> float:
    return tracer.counters1[name] - tracer.counters0[name]
