"""Lexical layer (``engine/bm25.py``, ``BM25Index.scores``): time a query's
scoring spent off its worker's CPU (wall time less the thread's CPU time:
the interpreter lock, blocking copies), ms a micro-batch (the program's
``bm25.scores`` spans over its ``batcher.batch`` spans in the traced
slice)."""

from ragbench.layer_metrics._spans import batches, named, slice_spans


def read(d):
    spans = slice_spans(d)
    if not spans:
        return None
    n, scores = len(batches(spans, d.kind)), named(spans, "bm25.scores")
    if not n or not scores:
        return None
    return sum(s.wall_ns - s.cpu_ns for s in scores) / n / 1e6
