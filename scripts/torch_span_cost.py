#!/usr/bin/env python3
"""What one span of ``archi_tpu_torch.utils.tracing`` costs the host.

Times, per call, in a loop of empty spans on one thread: the span off (the
default), on (``enable()``), and under a recording ``torch.profiler``
(CPU and, where there is a card, CUDA activities: the span also enters
``record_function``); and, for comparison, ``record_function`` with no
profiler and the two clocks a recorded span reads.  Each figure is the
median of five loops less the empty loop, in microseconds.

Usage (from the root of the repository):

    python3 -m scripts.torch_span_cost [calls]
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from archi_tpu_torch.utils import tracing


def _per_call_us(body, n: int) -> float:
    """Median of five loops of n calls, µs a call, less the empty loop."""
    def loop(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def empty():
        pass

    runs = [loop(body) - loop(empty) for _ in range(5)]
    return statistics.median(runs)


def _span():
    with tracing.span("cost"):
        pass


def _annotation():
    with torch.profiler.record_function("cost"):
        pass


def measure(n: int = 200_000) -> dict:
    out = {"device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "calls": n}
    tracing.enable(False)
    out["span_off_us"] = _per_call_us(_span, n)
    out["record_function_no_profiler_us"] = _per_call_us(_annotation, n // 10)
    out["perf_counter_ns_us"] = _per_call_us(time.perf_counter_ns, n)
    out["thread_time_ns_us"] = _per_call_us(time.thread_time_ns, n)
    tracing.enable()
    out["span_on_us"] = _per_call_us(_span, n // 4)
    tracing.enable(False)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["span_profiled_us"] = _per_call_us(_span, n // 40)
    out["dropped"] = tracing.dropped()
    tracing.clear()
    return out


if __name__ == "__main__":
    print(json.dumps(measure(int(sys.argv[1]) if len(sys.argv) > 1
                             else 200_000)))
