"""Scheduler (``engine/batcher.py``): mean time a request waited in the
queue, from its submit to the start of its micro-batch (the program's
``batcher.queue`` spans in the traced slice)."""

from ragbench.layer_metrics._spans import named, slice_spans


def read(d):
    spans = slice_spans(d)
    queued = named(spans, "batcher.queue") if spans else []
    if not queued:
        return None
    return sum(s.wall_ns for s in queued) / len(queued) / 1e6
