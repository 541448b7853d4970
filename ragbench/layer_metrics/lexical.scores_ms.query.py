"""Lexical layer (``engine/bm25.py`` under ``hybrid_search_batch``): the
BM25 scores of a micro-batch, ms a batch (the program's ``store.bm25``
spans over its ``batcher.batch`` spans in the traced slice)."""

from ragbench.layer_metrics._spans import batches, named, slice_spans


def read(d):
    spans = slice_spans(d)
    if not spans:
        return None
    n, bm25 = len(batches(spans, d.kind)), named(spans, "store.bm25")
    if not n or not bm25:
        return None
    return sum(s.wall_ns for s in bm25) / n / 1e6
