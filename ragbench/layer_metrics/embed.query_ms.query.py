"""Embedder (``models/embedder.py``, ``models/bert.py``): time of
``TorchVectorStore._embed_queries`` a micro-batch (tokenize, encode, copy
back), from the harness's spans."""


def read(d):
    spans = d.tracer.of("embed")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1, _ in spans) / len(spans)
