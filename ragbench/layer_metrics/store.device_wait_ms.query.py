"""Store (``engine/vectorstore.py`` and the layers under it): time the
host blocked on the device (the program's spans marked ``wait``: copies to
and from the card, the fallback test), ms a micro-batch over the
``batcher.batch`` spans in the traced slice."""

from ragbench.layer_metrics._spans import batches, slice_spans


def read(d):
    spans = slice_spans(d)
    if not spans:
        return None
    n = len(batches(spans, d.kind))
    waits = [s for s in spans if s.wait]
    if not n or not waits:
        return None
    return sum(s.wall_ns for s in waits) / n / 1e6
