#!/usr/bin/env python3
"""End-to-end ingest throughput on the PyTorch/CUDA port: text → tokenize →
embed (the encoder on the card) → BM25 → device index, through the
production ``TorchVectorStore.add_texts`` path.

Counterpart of ``scripts/bench_ingest.py``, with its arguments and printed
figures: a MiniLM-L6 ``TorchEmbedder(max_length=256)`` (random weights from
seed 0, the ASCII character vocabulary, as the JAX script's ``JaxEmbedder``)
into a bf16 ``FlatIndex``, pre-grown to the corpus size, one batch warmed
first; the last step is a hybrid query, which includes the BM25 flush.
``synth_texts`` is the JAX script's numpy generator, so the texts are the
same.  Times are the card's (host clock around work that ends in a
synchronise).

Usage (on the card, from the root of the repository):

    python3 scripts/torch_bench_ingest.py [n_chunks] [batch]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def synth_texts(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    vocab = np.array([f"term{i}" for i in range(20_000)])
    lens = rng.integers(60, 120, n)  # words per chunk (~600-1000 chars)
    return [" ".join(rng.choice(vocab, size=int(m))) for m in lens]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(n: int = 100_000, batch: int = 2048, *, embedder=None,
            device=None, log=print):
    """The JAX script's run → ``(payload, state)``: the figures it prints
    and ``state``: ``store`` and ``hits`` (the final hybrid query's
    results).  ``embedder`` replaces the MiniLM-L6 ``TorchEmbedder``;
    ``device``: the card unless ``"cpu"``."""
    import torch

    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    t0 = time.time()
    texts = synth_texts(n)
    gen_s = time.time() - t0

    if embedder is None:
        embedder = TorchEmbedder(max_length=256, device=dev)
    store = TorchVectorStore(
        embedder, index=FlatIndex(embedder.dim, dtype=torch.bfloat16,
                                  device=dev), device=dev)
    # bulk loads know the corpus size: pre-grow so that no capacity
    # doubling lands in the timed loop
    store.index._grow_to(n)
    # warm the bucketed shapes
    store.add_texts(texts[:batch], ids=[f"w{i}" for i in range(batch)])
    _sync(dev)

    t0 = time.time()
    for s in range(batch, n, batch):
        chunk = texts[s: s + batch]
        store.add_texts(chunk, ids=[f"c{i}" for i in range(s, s + len(chunk))])
    _sync(dev)
    elapsed = time.time() - t0
    done = n - batch
    # the BM25 device flush is included
    hits = store.hybrid_search("term1 term2", k=5)
    _sync(dev)
    total = time.time() - t0

    payload = {
        "n_chunks": n, "batch": batch, "corpus_gen_s": round(gen_s, 3),
        "ingested": done, "ingest_s": round(elapsed, 3),
        "chunks_per_s": round(done / elapsed, 1) if done else 0.0,
        "chunks_per_s_incl_flush": round(done / total, 1) if done else 0.0,
        "index_rows": store.count(), "bm25_docs": store.bm25.n_docs,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    log(f"corpus gen: {gen_s:.1f}s for {n} chunks")
    log(f"ingest: {done} chunks in {elapsed:.1f}s = "
        f"{payload['chunks_per_s']:.0f} chunks/s end-to-end "
        f"(tokenize+embed+bm25+index)")
    log(f"incl. first-query bm25 flush: "
        f"{payload['chunks_per_s_incl_flush']:.0f} chunks/s")
    log(f"index rows: {store.count()}  bm25 docs: {store.bm25.n_docs}")
    return payload, {"store": store, "hits": hits}


def run(n: int = 100_000, batch: int = 2048, **kw) -> dict:
    """``measure`` → its payload."""
    return measure(n, batch, **kw)[0]


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    print(json.dumps(run(n, batch, log=lambda m: print(m, flush=True))))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
