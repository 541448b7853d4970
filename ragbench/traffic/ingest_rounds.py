"""A deployment's initial ingestion: a closed loop of rounds, as fast as the
system goes.

Each round registers the next ``documents_per_round`` documents of the
corpus as local files through the program's persistence service and
catalog, as the local-files collector does, then runs one sync of the index
manager into the store, which starts empty.  The window closes at the end
of the first round that ends past ``--seconds``; the rate is every chunk
stored over all of that time.
"""

from __future__ import annotations

import os
import time
import types

from ragbench import deploy, textgen
from ragbench.check import expected_chunks, judge_ingest, token_lengths
from ragbench.reference.text import analyze
from ragbench.runctx import Outcome, Run
from ragbench.trace import counters
from ragbench.weights import encoder_weights

COUNTERS = ["archi_ingest_chunks"]


def warm(r: Run, emb, corpus, docs: list[str]) -> None:
    """Every (batch, sequence) bucket the encoder forms under ingest, then
    one round of the whole path into a store of its own."""
    from archi_tpu_torch.models.embedder import BATCH_BUCKETS, SEQ_BUCKETS

    max_len = r.config["encoder"]["max_length"]
    for s in SEQ_BUCKETS:
        if s > max_len:
            break
        for b in BATCH_BUCKETS:
            emb.encode_ids([[2] + [5] * (s - 2) + [3]] * b)
    st = deploy.store(r.config, emb, r.device)
    _, persistence, manager = deploy.ingest_pipeline(
        r.config, st, os.path.join(r.tmpdir, "warm"))
    for j, d in enumerate(docs):
        deploy.persist_document(persistence, d, f"warm{j:06d}.txt")
    manager.update_vectorstore()
    r.free()


def stored_view(st, catalog, sample: list[str]) -> dict:
    """What the program holds, read back to be judged."""
    ids = st.ids()
    texts = {}
    for cid in ids:
        docs = st.get_by_ids([cid])
        texts[cid] = docs[0].page_content if len(docs) == 1 else None
    rows = [st.index._id_rows[c][0] for c in sample]
    bm = st.bm25
    terms = {}
    for cid, row in zip(sample, rows):
        tf = {}
        for t in set(analyze(st._row_data[row][1])) | set(
                analyze(texts[cid] or "")):
            tid = bm._term_ids.get(t)
            f = bm._postings[tid].get(row) if tid is not None else None
            if f is not None:
                tf[t] = f
        terms[cid] = (bm._doc_len.get(row), tf)
    by_status = catalog.stats()["by_status"]
    return {"ids": ids, "texts": texts,
            "rows": st.index.emb[rows].float().cpu(),
            "terms": terms,
            "not_embedded": sum(by_status.values())
            - by_status.get("embedded", 0)}


def run(r: Run) -> Outcome:
    cfg, tr = r.config, r.traffic
    per = tr["documents_per_round"]
    corpus = deploy.corpus_module(cfg).Corpus(cfg, r.seed, r.device)
    weights = encoder_weights(cfg["encoder"], r.seed, r.device)
    emb = deploy.embedder(cfg, weights, corpus.wp_vocab, r.device)
    docs = corpus.documents
    r.log("corpus, weights and embedder made")
    warm(r, emb, corpus, docs[-per:])
    r.log("warm")
    docs = docs[:-per]
    st = deploy.store(cfg, emb, r.device)
    catalog, persistence, manager = deploy.ingest_pipeline(
        cfg, st, os.path.join(r.tmpdir, "run"))
    if r.tracer.enabled:
        r.tracer.wrap(st, "add_texts", "add_texts",
                      info=lambda a, kw, res: list(a[0]))
    sl0 = tr["trace_start"] * r.seconds
    r.tracer.arm()
    setup_s = r.setup_s()
    r.log(f"set-up {setup_s:.1f} s; rounds of {per} documents for "
          f"{r.seconds} s")
    i = rounds = 0
    with counters(r.tracer, COUNTERS):
        t0 = time.perf_counter()
        while i < len(docs):
            t_round = time.perf_counter()
            for j, d in enumerate(docs[i:i + per]):
                deploy.persist_document(persistence, d, f"doc{i + j:06d}.txt")
            manager.update_vectorstore()
            i = min(i + per, len(docs))
            rounds += 1
            now = time.perf_counter() - t0
            if now >= sl0:
                r.tracer.start_profile()
            r.log(f"round {rounds}: {time.perf_counter() - t_round:.3f} s, "
                  f"{st.count()} chunks")
            if now >= r.seconds:
                break
        t1 = time.perf_counter()
        r.tracer.stop_profile()
    peak = r.memory_peak()
    chunks = st.count()
    window = t1 - t0
    failed = catalog.stats()["by_status"].get("failed", 0)
    if i >= len(docs):
        r.log("the corpus ran out before the window closed")
    e2e = {"ingest_chunks_per_s": chunks / window}

    expected = expected_chunks(cfg, docs[:i])
    rng = textgen.rng_for(r.seed, "sample")
    have = sorted(set(expected) & set(st.ids()))
    longest = sorted(have, key=lambda c: -len(expected[c]))[:8]
    rest = sorted(set(have) - set(longest))
    m = max(0, min(tr["check_sample"], len(have)) - len(longest))
    sample = longest + [rest[j] for j in sorted(
        rng.choice(len(rest), m, replace=False).tolist())] if rest else longest
    stored = stored_view(st, catalog, sample)
    layer = types.SimpleNamespace(
        tracer=r.tracer, window_s=window, encoder=cfg["encoder"],
        token_lengths=token_lengths(corpus.wp_vocab, cfg))
    del manager, st, emb, persistence
    catalog.close()
    r.free()
    r.tracer.reduce()
    r.log(f"{rounds} rounds, {i} documents, {chunks} chunks in "
          f"{window:.3f} s; checking {len(sample)} rows against the reference")
    readings = judge_ingest(cfg, weights, corpus.wp_vocab, expected, stored,
                            sample, r.device, control=r.control)
    return Outcome(attempted=i, failed=failed, setup_s=setup_s,
                   end_to_end=e2e, memory_peak_bytes=peak, readings=readings,
                   layer_data=layer)
