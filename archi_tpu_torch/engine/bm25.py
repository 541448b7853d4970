"""Device-resident BM25 index: segmented postings + scatter-add scoring.

Counterpart of ``archi_tpu/engine/bm25.py``.

- Postings live in flat device tensors (rows [CAP] int32, tf [CAP] f32,
  dl [CAP] f32) grouped into per-term SEGMENTS, cut into CHUNK-sized
  PIECES when the buffers change.  For a batch of queries the host (which
  knows the queries' few terms) emits one work list of the pieces of every
  query's terms, copies it to the device once, and one scatter kernel
  (``ops/bm25.py``) computes the BM25 impacts and adds them into a dense
  [B, n_pad] score matrix.
- **Global stats enter at QUERY time**: each entry stores its raw term
  frequency and document length; ``idf(term)`` (exact, from the df
  counts) and ``avgdl`` (exact, from running totals) are applied per
  query.  Ingest is therefore incremental and exact.
- Incremental adds buffer a host-side delta; the first query after an
  ingest batch appends the delta to NEW device buffers and adds one
  segment per touched term.  After ``REBUILD_FLUSHES`` flushes (or on
  ``remove``) a full rebuild re-sorts postings into one segment per term.
  Each build or flush publishes a new ``_Snapshot`` (buffers, pieces, df
  counts and document stats) in one assignment: queries running
  concurrently keep the one they took, never a mix of two.
- The dense score rows feed the fused top-k as the per-row additive bias,
  or a stable sort for BM25-only ranking.

Scoring: Okapi BM25 with the Lucene-style non-negative idf
``ln(1 + (N - df + 0.5)/(df + 0.5))``, k1=1.2, b=0.75.  The JSON format of
``save``/``load`` is the JAX package's.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.models.tokenizer import basic_tokenize
from archi_tpu_torch.native import count_route, native_analyze
from archi_tpu_torch.ops.bm25 import IDF, LENGTH, QUERY, START, bm25_scatter
from archi_tpu_torch.utils.hardware import default_device
from archi_tpu_torch.utils.metrics import METRICS
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


def _cut(starts: np.ndarray, lengths: np.ndarray):
    """Segments (start, length) → their CHUNK-sized pieces [n, 2] int32
    (start, length), segment after segment, and each segment's count."""
    counts = -(-lengths // CHUNK)
    seg = np.repeat(np.arange(len(counts)), counts)
    off = (np.arange(int(counts.sum()))
           - np.repeat(np.cumsum(counts) - counts, counts)) * CHUNK
    pieces = np.stack([starts[seg] + off,
                       np.minimum(lengths[seg] - off, CHUNK)], 1)
    return pieces.astype(np.int32), counts


class _Snapshot(NamedTuple):
    """What a query reads, published by a build or flush in one assignment."""

    rows: Optional[torch.Tensor]   # [cap] int32 row of each entry
    tf: Optional[torch.Tensor]     # [cap] f32 term frequency
    dl: Optional[torch.Tensor]     # [cap] f32 document length
    nnz: int                       # live entries
    terms: dict                    # tid -> (pieces [n, 2] int32, df)
    n_docs: int
    len_sum: int


_EMPTY = _Snapshot(None, None, None, 0, {}, 0, 0)


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
        # queries take it only when they find pending work, and otherwise
        # read the published snapshot alone.
        self._mutate_lock = threading.RLock()
        self._snap = _EMPTY
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

    def _publish(self, entries, *, rebuild: bool) -> None:
        """Write the entries into NEW buffers (after the old entries unless
        ``rebuild``, grown as needed), cut the touched terms' new segments
        into pieces, and publish it all with the current stats; concurrent
        queries keep the old snapshot."""
        old = _EMPTY if rebuild else self._snap
        terms = {} if rebuild else dict(old.terms)
        new_rows, new_tf, new_dl = old.rows, old.tf, old.dl
        base, n = old.nnz, 0
        if entries is not None:
            rows, tfs, dls, spans = entries
            n = len(rows)
            need = base + _bucket_up(n, _DELTA_BUCKETS)
            cap = _DELTA_BUCKETS[0] if old.rows is None else old.rows.shape[0]
            while cap < need:
                cap *= 2
            dev = self.device
            new_rows = torch.zeros((cap,), dtype=torch.int32, device=dev)
            new_tf = torch.zeros((cap,), dtype=torch.float32, device=dev)
            new_dl = torch.zeros((cap,), dtype=torch.float32, device=dev)
            if base:
                new_rows[:base] = old.rows[:base]
                new_tf[:base] = old.tf[:base]
                new_dl[:base] = old.dl[:base]
            new_rows[base:base + n] = torch.from_numpy(rows).to(dev)
            new_tf[base:base + n] = torch.from_numpy(tfs).to(dev)
            new_dl[base:base + n] = torch.from_numpy(dls).to(dev)
            tids, rel, lengths = (np.array(c, np.int64) for c in zip(*spans))
            pieces, counts = _cut(base + rel, lengths)
            ends = np.cumsum(counts)
            for tid, lo, hi in zip(tids.tolist(), (ends - counts).tolist(),
                                   ends.tolist()):
                p = pieces[lo:hi]
                prev = terms.get(tid)
                if prev is not None:
                    p = np.concatenate([prev[0], p])
                terms[tid] = (p, len(self._postings[tid]))
        self._snap = _Snapshot(new_rows, new_tf, new_dl, base + n, terms,
                               len(self._doc_len), self._len_sum)

    def build(self) -> None:
        """Full rebuild: one contiguous segment per term.  Concurrent
        queries see the state before the build until it publishes."""
        with self._mutate_lock:
            self._delta.clear()
            self._publish(self._emit_entries(
                {tid: p for tid, p in enumerate(self._postings)}),
                rebuild=True)
            self._n_flushes = 0
            self._needs_rebuild = False
            self.full_builds += 1

    def _flush_delta(self) -> None:
        with self._mutate_lock:
            entries = self._emit_entries(self._delta)
            self._delta.clear()
            self._publish(entries, rebuild=False)
            if entries is not None:
                self._n_flushes += 1
                self.delta_flushes += 1

    def _ensure_built(self) -> None:
        snap = self._snap
        if not (self._needs_rebuild or self._n_flushes >= REBUILD_FLUSHES
                or self._delta or snap.n_docs != len(self._doc_len)
                or snap.len_sum != self._len_sum):
            return  # steady state: no locking on the query path
        with self._mutate_lock:  # one winner does the work; losers re-check
            if self._needs_rebuild or self._n_flushes >= REBUILD_FLUSHES:
                self.build()
            else:
                # the delta, or stats moved by documents with no terms
                self._flush_delta()

    # ------------------------------------------------------------------ query
    def query_terms(self, query: str) -> list[str]:
        return analyze(query, stemming=self.stemming)

    def scores(self, query: str, n_pad: int) -> torch.Tensor:
        """Dense [n_pad] BM25 scores for the query (0 where no term hits):
        ``scores_batch`` of the one query."""
        return self._score([query], n_pad, 1, "single")[0][0]

    def scores_batch(self, queries: Sequence[str], n_pad: int, *,
                     n_rows: Optional[int] = None):
        """BM25 scores of a batch of queries in one pass: one work list,
        one copy to the device, one scatter.

        Returns (scores [n_rows, n_pad] f32, hit [n_rows] bool) on the
        index's device; row i < len(queries) holds query i's scores and
        ``hit[i]`` whether any of its postings landed below n_pad (its best
        score is above 0); rows past the queries (``n_rows``, default
        ``len(queries)``, pads a batch) are zero."""
        queries = list(queries)
        n_rows = len(queries) if n_rows is None else n_rows
        if n_rows < len(queries):
            raise ValueError(f"scores_batch: n_rows {n_rows} < "
                             f"{len(queries)} queries")
        return self._score(queries, n_pad, n_rows, "batch")

    def _score(self, queries: list, n_pad: int, n_rows: int, path: str):
        with span("bm25.scores") as sp:
            self._ensure_built()
            snap = self._snap
            with span("bm25.analyze"):
                term_sets = [set(self.query_terms(q)) for q in queries]
            with span("bm25.worklist"):
                work = self._worklist(snap, term_sets)
            METRICS.inc("archi_bm25_scored_queries_total", len(queries),
                        labels={"path": path})
            if sp.recording:
                sp.set(queries=len(queries), pieces=len(work),
                       entries=int(work[:, LENGTH].sum()))
            if snap.rows is None:   # no postings yet
                return (torch.zeros((n_rows, n_pad), dtype=torch.float32,
                                    device=self.device),
                        torch.zeros((n_rows,), dtype=torch.bool,
                                    device=self.device))
            with span("bm25.upload"):
                work_t = self._upload(work)
            with span("bm25.scatter"):
                avgdl = snap.len_sum / snap.n_docs if snap.n_docs else 1.0
                return bm25_scatter(
                    snap.rows, snap.tf, snap.dl, work_t,
                    float(np.float32(1.0 / max(avgdl, 1e-9))),
                    n_pad=n_pad, n_rows=n_rows, k1=self.k1, b=self.b)

    def _worklist(self, snap: _Snapshot, term_sets) -> np.ndarray:
        """[W, 4] int32 work list (query, start, length, the bits of the
        f32 idf) over the pieces of every query's terms; each idf computed
        once a batch, from the snapshot's counts."""
        n = max(snap.n_docs, 1)
        idf_of_df: dict[int, float] = {}
        parts, owners, weights = [], [], []
        for qi, terms in enumerate(term_sets):
            for t in terms:
                entry = snap.terms.get(self._term_ids.get(t))
                if entry is None:
                    continue
                pieces, df = entry
                idf = idf_of_df.get(df)
                if idf is None:
                    idf = idf_of_df[df] = math.log(
                        1.0 + (n - df + 0.5) / (df + 0.5))
                parts.append(pieces)
                owners.append(qi)
                weights.append(idf)
        if not parts:
            return np.zeros((0, 4), np.int32)
        counts = [len(p) for p in parts]
        work = np.empty((sum(counts), 4), np.int32)
        work[:, QUERY] = np.repeat(owners, counts)
        work[:, START:LENGTH + 1] = np.concatenate(parts)
        work[:, IDF] = np.repeat(np.asarray(weights, np.float32),
                                 counts).view(np.int32)
        return work

    def _upload(self, work: np.ndarray) -> torch.Tensor:
        """The work list on the device.  On CUDA one copy from pinned
        memory that does not wait for the stream; PyTorch's pinned-memory
        cache keeps the buffer from reuse until the copy has run."""
        if self.device.type != "cuda" or not len(work):
            return torch.from_numpy(work).to(self.device)
        host = torch.empty(work.shape, dtype=torch.int32, pin_memory=True)
        host.numpy()[...] = work
        return host.to(self.device, non_blocking=True)

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
