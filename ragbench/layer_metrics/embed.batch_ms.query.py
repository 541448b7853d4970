"""Embedder (``models/embedder.py``, ``models/bert.py``): the queries'
embedding a micro-batch (tokenize, encode, copy back), mean ms of the
program's ``store.embed`` spans in the traced slice."""

from ragbench.layer_metrics._spans import named, slice_spans


def read(d):
    spans = slice_spans(d)
    embeds = named(spans, "store.embed") if spans else []
    if not embeds:
        return None
    return sum(s.wall_ns for s in embeds) / len(embeds) / 1e6
