"""Device-resident BM25 index: segmented postings + scatter-add scoring.

Counterpart of ``archi_tpu/engine/bm25.py``.

- Postings live in flat device tensors (rows [CAP] int32, tf [CAP] f32,
  dl [CAP] f32) grouped into per-term SEGMENTS.  The host (which knows the
  query's few terms) emits a list of chunk descriptors over the query
  terms' segments; the device gathers those entries, computes the BM25
  impacts and ``index_add_``s them into a dense [n_pad] score vector.
- **Global stats enter at QUERY time**: each entry stores its raw term
  frequency and document length; ``idf(term)`` (exact, from the host df
  counter) and ``avgdl`` (exact, from running totals) are applied per
  query.  Ingest is therefore incremental and exact.
- Incremental adds buffer a host-side delta; the first query after an
  ingest batch appends the delta to NEW device buffers (queries running
  concurrently keep their snapshot) and adds one segment per touched term.
  After ``REBUILD_FLUSHES`` flushes (or on ``remove``) a full rebuild
  re-sorts postings into one segment per term.
- The dense score vector feeds the fused top-k as the per-row additive
  bias, or a stable sort for BM25-only ranking.

Scoring: Okapi BM25 with the Lucene-style non-negative idf
``ln(1 + (N - df + 0.5)/(df + 0.5))``, k1=1.2, b=0.75.  The JSON format of
``save``/``load`` is the JAX package's.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Sequence

import numpy as np
import torch

from archi_tpu_torch.models.tokenizer import basic_tokenize
from archi_tpu_torch.native import count_route, native_analyze
from archi_tpu_torch.utils.hardware import default_device
from archi_tpu_torch.utils.stemmer import stem as porter_stem
from archi_tpu_torch.utils.tracing import span

CHUNK = 2048  # postings per work-list chunk
_DELTA_BUCKETS = (2048, 8192, 32768, 131072, 524288)
#: full rebuild (one segment per term) after this many delta flushes.
REBUILD_FLUSHES = 64

STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


def _bucket_up(x, buckets):
    for b in buckets:
        if x <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(x, 2))))


def analyze(text: str, *, stemming: bool = False,
            stopwords: frozenset = STOPWORDS) -> list[str]:
    """Text → lexical terms (lowercase, stopword-filtered, optional Porter).

    ASCII texts (and Latin texts that transliterate to ASCII) run through
    the C++ analyzer (``archi_tpu_torch/native/text_analyzer.cc``) when it
    is available and the stopwords are the default ones — the same terms,
    without the per-character Python loop of the ingest hot path."""
    if stopwords is STOPWORDS:
        terms = native_analyze(text, stemming=stemming)
        if terms is not None:
            count_route("analyze:native")
            return terms
    count_route("analyze:python")
    toks = [t for t in basic_tokenize(text)
            if len(t) > 1 and not t.isdigit() and t not in stopwords
            and t.isalnum()]
    if stemming:
        toks = [porter_stem(t) for t in toks]
    return toks


def scatter_scores(rows_buf, tf_buf, dl_buf, starts, lens, idfs,
                   inv_avgdl: float, *, n_pad: int, k1: float, b: float):
    """Score the work-list chunks into a dense [n_pad] f32 vector.

    Chunk i covers entries [starts[i], starts[i] + lens[i]) of the postings
    buffers with idf idfs[i]; impacts of one row add up over the chunks."""
    dev = rows_buf.device
    # copies from host lists: on the card each waits for the stream
    with span("bm25.upload", wait=True):
        lens_t = torch.as_tensor(lens, dtype=torch.long, device=dev)
        starts_t = torch.as_tensor(starts, dtype=torch.long, device=dev)
        idfs_t = torch.as_tensor(idfs, dtype=torch.float32, device=dev)
    total = int(np.sum(lens))
    chunk = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), lens_t, output_size=total)
    first = torch.cumsum(lens_t, 0) - lens_t           # output offset of each
    pos = starts_t[chunk] + torch.arange(total, device=dev) - first[chunk]
    tf = tf_buf[pos]
    dl = dl_buf[pos]
    denom = tf + k1 * (1.0 - b + b * dl * inv_avgdl)
    imps = idfs_t[chunk] * tf * (k1 + 1.0) / torch.clamp(denom, min=1e-9)
    # rows past n_pad land in one extra slot that is cut off
    rows = torch.clamp(rows_buf[pos].long(), max=n_pad)
    scores = torch.zeros((n_pad + 1,), dtype=torch.float32, device=dev)
    return scores.index_add_(0, rows, imps)[:n_pad]


class BM25Index:
    """Incremental BM25 index keyed by physical row ids (shared with the
    vector index so hybrid fusion is a per-row add)."""

    def __init__(self, *, k1: float = 1.2, b: float = 0.75,
                 stemming: bool = False, device=None):
        self.k1 = k1
        self.b = b
        self.stemming = stemming
        self.device = default_device(device)
        self._term_ids: dict[str, int] = {}
        self._postings: list[dict[int, int]] = []  # term_id -> {row: tf}
        self._doc_len: dict[int, int] = {}          # row -> length
        self._len_sum = 0
        # _mutate_lock serialises every mutator (add/remove/build/flush);
        # queries take it only when they find pending work.  _buf_lock
        # guards the device-buffer swap so queries snapshot a consistent
        # (rows, tf, dl, segments) view.
        self._mutate_lock = threading.RLock()
        self._buf_lock = threading.Lock()
        self._rows_buf = None
        self._tf_buf = None
        self._dl_buf = None
        self._nnz = 0          # live entries in the buffers
        self._cap = 0
        self._term_segments: dict[int, list[tuple[int, int]]] = {}
        # delta since last flush: term_id -> {row: tf}
        self._delta: dict[int, dict[int, int]] = {}
        self._n_flushes = 0
        self._needs_rebuild = True
        # telemetry
        self.full_builds = 0
        self.delta_flushes = 0

    # ------------------------------------------------------------------ build
    def analyze_batch(self, texts: Sequence[str]) -> list[list[str]]:
        return [analyze(t, stemming=self.stemming) for t in texts]

    def add(self, rows: Sequence[int], texts: Sequence[str]) -> None:
        if len(rows) != len(texts):
            raise ValueError(f"add: {len(rows)} rows for {len(texts)} texts")
        self.add_analyzed(rows, self.analyze_batch(texts))

    def add_analyzed(self, rows: Sequence[int],
                     term_lists: Sequence[list[str]]) -> None:
        if len(rows) != len(term_lists):
            raise ValueError(
                f"add_analyzed: {len(rows)} rows for {len(term_lists)} lists")
        with self._mutate_lock:
            for row, terms in zip(rows, term_lists):
                self._doc_len[row] = len(terms)
                self._len_sum += len(terms)
                tf: dict[int, int] = {}
                for t in terms:
                    tid = self._term_ids.setdefault(t, len(self._term_ids))
                    if tid == len(self._postings):
                        self._postings.append({})
                    tf[tid] = tf.get(tid, 0) + 1
                for tid, f in tf.items():
                    self._postings[tid][row] = f
                    self._delta.setdefault(tid, {})[row] = f

    def remove(self, rows: Sequence[int]) -> None:
        """Hard-remove rows (callers usually just mask; used by compaction)."""
        with self._mutate_lock:
            rowset = set(rows)
            for plist in self._postings:
                for r in rowset & plist.keys():
                    del plist[r]
            for r in rowset:
                n = self._doc_len.pop(r, None)
                if n is not None:
                    self._len_sum -= n
            if rowset:
                self._needs_rebuild = True
                self._delta.clear()

    @property
    def n_docs(self) -> int:
        return len(self._doc_len)

    @property
    def n_terms(self) -> int:
        return len(self._term_ids)

    @property
    def avgdl(self) -> float:
        return (self._len_sum / self.n_docs) if self._doc_len else 1.0

    def _idf(self, tid: int) -> float:
        df = len(self._postings[tid])
        n = max(self.n_docs, 1)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def _emit_entries(self, postings: dict[int, dict[int, int]]):
        """postings → (rows, tf, dl arrays grouped by term, per-term spans)."""
        rows_parts, tf_parts = [], []
        spans: list[tuple[int, int, int]] = []  # (tid, rel_start, length)
        off = 0
        for tid in sorted(postings):
            plist = postings[tid]
            if not plist:
                continue
            df = len(plist)
            rows_parts.append(np.fromiter(plist.keys(), np.int32, df))
            tf_parts.append(np.fromiter(plist.values(), np.float32, df))
            spans.append((tid, off, df))
            off += df
        if not spans:
            return None
        rows = np.concatenate(rows_parts)
        tfs = np.concatenate(tf_parts)
        dls = np.array([self._doc_len.get(int(r), 0) for r in rows],
                       np.float32)
        return rows, tfs, dls, spans

    def _append_device(self, rows, tfs, dls, spans) -> None:
        """Write the entries at _nnz into NEW buffers (grown as needed) and
        publish them; concurrent queries keep the old ones."""
        n = len(rows)
        need = self._nnz + _bucket_up(n, _DELTA_BUCKETS)
        cap = max(self._cap, _DELTA_BUCKETS[0])
        while cap < need:
            cap *= 2
        dev = self.device
        new_rows = torch.zeros((cap,), dtype=torch.int32, device=dev)
        new_tf = torch.zeros((cap,), dtype=torch.float32, device=dev)
        new_dl = torch.zeros((cap,), dtype=torch.float32, device=dev)
        base = self._nnz
        if self._rows_buf is not None and base:
            new_rows[:base] = self._rows_buf[:base]
            new_tf[:base] = self._tf_buf[:base]
            new_dl[:base] = self._dl_buf[:base]
        new_rows[base:base + n] = torch.from_numpy(rows).to(dev)
        new_tf[base:base + n] = torch.from_numpy(tfs).to(dev)
        new_dl[base:base + n] = torch.from_numpy(dls).to(dev)
        segments = {t: list(s) for t, s in self._term_segments.items()}
        for tid, rel, length in spans:
            segments.setdefault(tid, []).append((base + rel, length))
        with self._buf_lock:
            self._rows_buf, self._tf_buf, self._dl_buf = new_rows, new_tf, new_dl
            self._cap = cap
            self._nnz = base + n
            self._term_segments = segments

    def build(self) -> None:
        """Full rebuild: one contiguous segment per term.  Concurrent
        queries see either the pre-build state or (briefly) an empty
        snapshot — never a torn one."""
        with self._mutate_lock:
            with self._buf_lock:
                self._rows_buf = self._tf_buf = self._dl_buf = None
                self._cap = 0
                self._nnz = 0
                self._term_segments = {}
            self._delta.clear()
            entries = self._emit_entries(
                {tid: p for tid, p in enumerate(self._postings)})
            if entries is not None:
                self._append_device(*entries)
            self._n_flushes = 0
            self._needs_rebuild = False
            self.full_builds += 1

    def _flush_delta(self) -> None:
        with self._mutate_lock:
            entries = self._emit_entries(self._delta)
            self._delta.clear()
            if entries is None:
                return
            self._append_device(*entries)
            self._n_flushes += 1
            self.delta_flushes += 1

    def _ensure_built(self) -> None:
        if not (self._needs_rebuild or self._n_flushes >= REBUILD_FLUSHES
                or self._delta):
            return  # steady state: no locking on the query path
        with self._mutate_lock:  # one winner does the work; losers re-check
            if self._needs_rebuild or self._n_flushes >= REBUILD_FLUSHES:
                self.build()
            elif self._delta:
                self._flush_delta()

    # ------------------------------------------------------------------ query
    def query_terms(self, query: str) -> list[str]:
        return analyze(query, stemming=self.stemming)

    def scores(self, query: str, n_pad: int) -> torch.Tensor:
        """Dense [n_pad] BM25 scores for the query (0 where no term hits)."""
        with span("bm25.scores"):
            self._ensure_built()
            with self._buf_lock:  # consistent snapshot vs concurrent ingest
                rows_buf, tf_buf, dl_buf = (
                    self._rows_buf, self._tf_buf, self._dl_buf)
                segments = self._term_segments
            with span("bm25.analyze"):
                terms = set(self.query_terms(query))
            with span("bm25.worklist"):
                starts, lens, idfs = [], [], []
                for t in terms:
                    tid = self._term_ids.get(t)
                    if tid is None:
                        continue
                    idf = self._idf(tid)
                    for start, length in segments.get(tid, ()):
                        while length > 0:
                            step = min(length, CHUNK)
                            starts.append(start)
                            lens.append(step)
                            idfs.append(idf)
                            start += step
                            length -= step
            if not starts or rows_buf is None:
                return torch.zeros((n_pad,), dtype=torch.float32,
                                   device=self.device)
            with span("bm25.scatter"):
                return scatter_scores(
                    rows_buf, tf_buf, dl_buf, starts, lens,
                    np.asarray(idfs, np.float32),
                    float(np.float32(1.0 / max(self.avgdl, 1e-9))),
                    n_pad=n_pad, k1=self.k1, b=self.b)

    def topk(self, query: str, n_pad: int, k: int = 10, *, alive_bias=None):
        """BM25-only ranking (vals, rows); rows with no hits score 0.  Equal
        scores keep the lower row, as ``lax.top_k`` does."""
        s = self.scores(query, n_pad)
        if alive_bias is not None:
            s = s + alive_bias
        k = min(k, n_pad)
        vals, rows = torch.sort(s, descending=True, stable=True)
        return vals[:k], rows[:k].to(torch.int32)

    # -------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = {
            "k1": self.k1, "b": self.b, "stemming": self.stemming,
            "terms": self._term_ids,
            "postings": [
                {str(r): f for r, f in p.items()} for p in self._postings
            ],
            "doc_len": {str(r): l for r, l in self._doc_len.items()},
        }
        with open(path, "w") as f:
            json.dump(state, f)

    @classmethod
    def load(cls, path: str, *, device=None) -> "BM25Index":
        with open(path) as f:
            state = json.load(f)
        idx = cls(k1=state["k1"], b=state["b"], stemming=state["stemming"],
                  device=device)
        idx._term_ids = {t: int(i) for t, i in state["terms"].items()}
        idx._postings = [
            {int(r): int(f) for r, f in p.items()} for p in state["postings"]
        ]
        idx._doc_len = {int(r): int(l) for r, l in state["doc_len"].items()}
        idx._len_sum = sum(idx._doc_len.values())
        return idx
