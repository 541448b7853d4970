"""What the readers of the program's own spans share: the spans of the
traced slice from ``archi_tpu_torch.utils.tracing`` and the micro-batches
among them.

A program without that recorder, a run without a slice, a ring that let
spans go, or a slice that holds none gives ``None``, and the reader
reports nothing."""

from __future__ import annotations

from ragbench.layer_metrics._common import scan_bound_s


def slice_spans(d):
    """The program's spans that end in the traced slice, or None."""
    try:
        from archi_tpu_torch.utils import tracing
    except ImportError:
        return None
    sl = d.tracer.slice
    if not sl or sl[1] is None or tracing.dropped():
        return None
    return tracing.spans(*sl) or None


def batches(spans, kind: str) -> list:
    """The scheduler's micro-batches of the cell's kind."""
    return [s for s in spans if s.name == "batcher.batch"
            and s.attrs.get("kind") == kind]


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def under_batches(spans, name: str, kind: str) -> list:
    """Spans of ``name`` whose chain of parents reaches a micro-batch of
    the cell's kind in the slice."""
    by_id = {s.id: s for s in spans}
    roots = {s.id for s in batches(spans, kind)}
    out = []
    for s in named(spans, name):
        p = s.parent
        while p is not None and p not in roots and p in by_id:
            p = by_id[p].parent
        if p in roots:
            out.append(s)
    return out


def dispatch_bound_s(d, s) -> float:
    """The least time of the scan an ``index.dispatch`` span launched."""
    bias = "per_query" if s.attrs["bias"] == "per_query" else "shared"
    return scan_bound_s(d, s.attrs["batch"], s.attrs["live"], bias)
