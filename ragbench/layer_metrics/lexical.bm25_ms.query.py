"""Lexical layer (``engine/bm25.py``, ``BM25Index.scores``): host time of
the BM25 scoring a micro-batch, from the harness's spans."""


def read(d):
    bm25 = d.tracer.of("bm25")
    batches = d.tracer.of("batch")
    if not bm25 or not batches:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1, _ in bm25) / len(batches)
