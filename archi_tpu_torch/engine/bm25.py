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
- On the host the postings are columnar: an ``add`` analyses its batch
  of texts straight to term ids (``native.NativeTermIds``, one call for the
  ASCII texts) and groups them with one sort into a block of (term id,
  row, tf) entries, term ids ascending, each term's rows in the order they
  came; document lengths live in an array indexed by row.
- The blocks since the last publish are the delta: the first query after
  an ingest batch appends them to NEW device buffers and adds one segment
  per touched term.  After ``REBUILD_FLUSHES`` flushes (or on ``remove``,
  or an add of a row that has postings) a full rebuild merges every block
  with one stable sort by term id into one segment per term.
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

import itertools
import json
import math
import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.models.tokenizer import basic_tokenize
from archi_tpu_torch.native import (NativeTermIds, count_route,
                                    native_analyze, native_enabled,
                                    prepare_for_native)
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


class _Block(NamedTuple):
    """Postings added together: term ids ascending, each term's rows in the
    order they were added."""

    tid: np.ndarray   # int32
    row: np.ndarray   # int32
    tf: np.ndarray    # int32


_NO_BLOCK = _Block(np.empty(0, np.int32), np.empty(0, np.int32),
                   np.empty(0, np.int32))


def _runs(a: np.ndarray):
    """(start, length) of each run of equal values in a non-empty sorted
    ``a``."""
    edge = np.empty(len(a), bool)
    edge[0] = True
    np.not_equal(a[1:], a[:-1], out=edge[1:])
    starts = np.flatnonzero(edge)
    lengths = np.empty_like(starts)
    lengths[:-1] = starts[1:] - starts[:-1]
    lengths[-1] = len(a) - starts[-1]
    return starts, lengths


def _merge(blocks: list, *, dedupe: bool) -> _Block:
    """Blocks → one block: one stable sort by term id, so each term's rows
    stay in the order they were added.  ``dedupe`` leaves one entry per
    (term, row), in the place of its first add and with its latest tf, as
    a dict updated in that order would."""
    if not blocks:
        return _NO_BLOCK
    if len(blocks) == 1 and not dedupe:
        return blocks[0]
    tid = np.concatenate([b.tid for b in blocks])
    order = np.argsort(tid, kind="stable")
    tid = tid[order]
    row = np.concatenate([b.row for b in blocks])[order]
    tf = np.concatenate([b.tf for b in blocks])[order]
    if dedupe and len(tid):
        key = (tid.astype(np.int64) << 32) | row
        by_key = np.argsort(key, kind="stable")
        starts, lengths = _runs(key[by_key])
        latest = tf[by_key[starts + lengths - 1]]
        keep = by_key[starts]
        place = np.argsort(keep)
        keep = keep[place]
        tid, row, tf = tid[keep], row[keep], latest[place]
    return _Block(tid, row, tf)


class _TermRows:
    """One term's postings, read-only: ``get(row)`` is the term's count in
    the row (the latest, if the row was added again), ``len()`` its rows."""

    __slots__ = ("_rows", "_tf")

    def __init__(self, rows: np.ndarray, tf: np.ndarray):
        self._rows, self._tf = rows, tf

    def get(self, row: int, default=None):
        hit = np.flatnonzero(self._rows == row)
        return int(self._tf[hit[-1]]) if len(hit) else default

    def __len__(self) -> int:
        return len(np.unique(self._rows))


class _PostingsView:
    """``index._postings[tid]``: a term's ``_TermRows``."""

    __slots__ = ("_index",)

    def __init__(self, index: "BM25Index"):
        self._index = index

    def __len__(self) -> int:
        return self._index.n_terms

    def __getitem__(self, tid: int) -> _TermRows:
        if not 0 <= tid < self._index.n_terms:
            raise IndexError(f"term id {tid} out of range")
        rows, tfs = [], []
        for b in self._index._blocks:
            lo, hi = np.searchsorted(b.tid, [tid, tid + 1])
            rows.append(b.row[lo:hi])
            tfs.append(b.tf[lo:hi])
        return _TermRows(np.concatenate(rows or [_NO_BLOCK.row]),
                         np.concatenate(tfs or [_NO_BLOCK.tf]))


class _DocLens:
    """``index._doc_len``: ``get(row)`` is the row's number of terms (None
    if the row has no document), ``len()`` the documents."""

    __slots__ = ("_index",)

    def __init__(self, index: "BM25Index"):
        self._index = index

    def __len__(self) -> int:
        return self._index.n_docs

    def get(self, row: int, default=None):
        lens = self._index._lens
        n = int(lens[row]) if 0 <= row < len(lens) else -1
        return n if n >= 0 else default


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
        # the native library's copy of _term_ids (made at the first native
        # add), and the terms interned since on the Python route, in id
        # order, that it still lacks
        self._native: Optional[NativeTermIds] = None
        self._unsynced: list[str] = []
        self._blocks: list[_Block] = []
        self._df = np.zeros(0, np.int64)     # term id -> rows with it
        self._lens = np.full(0, -1, np.int32)  # row -> terms, -1: none
        self._seq = np.zeros(0, np.int64)    # row -> order of its first add
        self._n_seq = 0
        self._n_docs = 0
        self._len_sum = 0
        # an add met a row that had postings: a (term, row) may be in the
        # blocks twice until the next full build merges them
        self._upserted = False
        # _mutate_lock serialises every mutator (add/remove/build/flush);
        # queries take it only when they find pending work, and otherwise
        # read the published snapshot alone.
        self._mutate_lock = threading.RLock()
        self._snap = _EMPTY
        self._pending = 0   # trailing blocks not yet published: the delta
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
        self._add(rows, texts, self._analyze_ids)

    def add_analyzed(self, rows: Sequence[int],
                     term_lists: Sequence[list[str]]) -> None:
        if len(rows) != len(term_lists):
            raise ValueError(
                f"add_analyzed: {len(rows)} rows for {len(term_lists)} lists")
        self._add(rows, term_lists, self._term_list_ids)

    def _add(self, rows, items, to_ids) -> None:
        rows = np.asarray(rows, np.int64).reshape(len(items))
        if len(rows) and (rows.min() < 0 or rows.max() >= 2 ** 31):
            raise ValueError("add: rows must lie in [0, 2**31)")
        with self._mutate_lock, span("bm25.add") as sp:
            ids, counts = to_ids(items)
            entries = self._add_ids(rows, ids, counts)
            if sp.recording:
                sp.set(texts=len(items), tokens=len(ids), entries=entries)

    def _term_list_ids(self, term_lists: Sequence[list[str]]):
        """Term lists → (ids int32, counts int32), new terms taking the
        next ids (the Python route)."""
        tids = self._term_ids
        ids = []
        for terms in term_lists:
            for t in terms:
                tid = tids.get(t)
                if tid is None:
                    tid = tids[t] = len(tids)
                    self._unsynced.append(t)
                ids.append(tid)
        return (np.array(ids, np.int32),
                np.fromiter(map(len, term_lists), np.int32, len(term_lists)))

    def _native_table(self) -> Optional[NativeTermIds]:
        if not native_enabled():
            return None
        if self._native is None:
            self._native = NativeTermIds()
            self._native.push(sorted(self._term_ids,
                                     key=self._term_ids.__getitem__))
            self._unsynced.clear()
        return self._native

    def _analyze_ids(self, texts: Sequence[str]):
        """Texts → (ids int32 of every text's terms in order, counts int32
        of terms a text).  Runs of texts the native analyzer takes go to it
        in one call each; the others take ``analyze``'s Python route.  Runs
        stay in order, so new terms get their ids in the order they occur,
        on either route."""
        table = self._native_table()
        prepared = [None if table is None else prepare_for_native(t)
                    for t in texts]
        ids, counts = [_NO_BLOCK.tid], [_NO_BLOCK.tid]
        for native, run in itertools.groupby(
                zip(texts, prepared), key=lambda tp: tp[1] is not None):
            run = list(run)
            if native:
                table.push(self._unsynced)
                self._unsynced.clear()
                got, n, new = table.analyze([p for _, p in run],
                                            stemming=self.stemming)
                base = len(self._term_ids)
                self._term_ids.update(zip(new, range(base, base + len(new))))
            else:
                got, n = self._term_list_ids(
                    self.analyze_batch([t for t, _ in run]))
            ids.append(got)
            counts.append(n)
        return np.concatenate(ids), np.concatenate(counts)

    def _add_ids(self, rows: np.ndarray, ids: np.ndarray,
                 counts: np.ndarray) -> int:
        """Add texts as term ids (``counts[i]`` of them for ``rows[i]``):
        one block of (term, row, tf) entries and the rows' lengths, as a
        dict of rows a term updated text by text would hold them.  Returns
        the block's entries."""
        n = len(counts)
        if not n:
            return 0
        # documents: a row's length is its last text's; its place in the
        # order of rows is its first add's
        self._grow_rows(int(rows.max()) + 1)
        uniq, first = np.unique(rows, return_index=True)
        last = first
        if len(uniq) < n:
            last = n - 1 - np.unique(rows[::-1], return_index=True)[1]
            self._upserted = True
        new = self._lens[uniq] < 0
        n_new = np.count_nonzero(new)
        if n_new < len(uniq):
            self._upserted = True
        self._seq[uniq[new]] = self._n_seq + first[new]
        self._n_seq += n
        self._lens[uniq] = counts[last]
        self._n_docs += n_new
        self._len_sum += int(counts.sum())
        entries = 0
        if len(ids):
            # one entry per (term, text), its count the tf; within a term
            # the texts stay in batch order
            key = np.repeat(np.arange(n, dtype=np.int64), counts)
            key |= ids.astype(np.int64) << 32
            key.sort()
            starts, tf = _runs(key)
            key = key[starts]
            tid = (key >> 32).astype(np.int32)
            row = rows[key & 0xFFFFFFFF].astype(np.int32)
            if len(self._df) < len(self._term_ids):
                self._df = np.concatenate([self._df, np.zeros(
                    max(len(self._term_ids), 2 * len(self._df))
                    - len(self._df), np.int64)])
            np.add.at(self._df, tid, 1)   # a (term, row) is one entry
            self._blocks.append(_Block(tid, row, tf.astype(np.int32)))
            self._pending += 1
            entries = len(tid)
        if self._upserted:
            self._needs_rebuild = True
        return entries

    def _grow_rows(self, need: int) -> None:
        have = len(self._lens)
        if need <= have:
            return
        cap = max(need, 2 * have, 1024)
        self._lens = np.concatenate([self._lens,
                                     np.full(cap - have, -1, np.int32)])
        self._seq = np.concatenate([self._seq,
                                    np.zeros(cap - have, np.int64)])

    def remove(self, rows: Sequence[int]) -> None:
        """Hard-remove rows (callers usually just mask; used by compaction)."""
        with self._mutate_lock:
            rows = np.unique(np.asarray(list(rows), np.int64))
            if not len(rows):
                return
            rows = rows[(rows >= 0) & (rows < len(self._lens))]
            live = rows[self._lens[rows] >= 0]
            if len(live):
                self._len_sum -= int(self._lens[live].sum())
                self._n_docs -= len(live)
                self._lens[live] = -1
                kept = []
                for b in self._blocks:
                    keep = ~np.isin(b.row, live)
                    if keep.all():
                        kept.append(b)
                    elif keep.any():
                        kept.append(_Block(b.tid[keep], b.row[keep],
                                           b.tf[keep]))
                self._blocks = kept
            self._needs_rebuild = True
            self._pending = 0

    @property
    def n_docs(self) -> int:
        return self._n_docs

    @property
    def n_terms(self) -> int:
        return len(self._term_ids)

    @property
    def avgdl(self) -> float:
        return (self._len_sum / self._n_docs) if self._n_docs else 1.0

    @property
    def _postings(self) -> _PostingsView:
        """Read-only: ``_postings[tid].get(row)``, ``len(_postings[tid])``."""
        return _PostingsView(self)

    @property
    def _doc_len(self) -> _DocLens:
        """Read-only: ``_doc_len.get(row)``, ``len(_doc_len)``."""
        return _DocLens(self)

    def _entries(self, block: _Block):
        """A block → (rows, tf, dl) as the device buffers hold them, and
        its terms' (ids, starts in the block, lengths)."""
        if not len(block.tid):
            return None
        starts, lengths = _runs(block.tid)
        dl = np.maximum(self._lens[block.row], 0).astype(np.float32)
        return (block.row, block.tf.astype(np.float32), dl,
                block.tid[starts], starts, lengths)

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
            rows, tfs, dls, tids, rel, lengths = entries
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
            pieces, counts = _cut(base + rel, lengths)
            ends = np.cumsum(counts)
            for tid, lo, hi, df in zip(tids.tolist(),
                                       (ends - counts).tolist(),
                                       ends.tolist(),
                                       self._df[tids].tolist()):
                p = pieces[lo:hi]
                prev = terms.get(tid)
                if prev is not None:
                    p = np.concatenate([prev[0], p])
                terms[tid] = (p, df)
        self._snap = _Snapshot(new_rows, new_tf, new_dl, base + n, terms,
                               self._n_docs, self._len_sum)

    def build(self) -> None:
        """Full rebuild: one contiguous segment per term.  Concurrent
        queries see the state before the build until it publishes."""
        with self._mutate_lock, span("bm25.build") as sp:
            block = _merge(self._blocks, dedupe=self._upserted)
            self._blocks = [block] if len(block.tid) else []
            self._upserted = False
            self._pending = 0
            self._df = np.bincount(block.tid, minlength=len(self._df))
            self._publish(self._entries(block), rebuild=True)
            self._n_flushes = 0
            self._needs_rebuild = False
            self.full_builds += 1
            if sp.recording:
                sp.set(entries=len(block.tid))

    def _flush_delta(self) -> None:
        with self._mutate_lock:
            block = _NO_BLOCK
            if self._pending:
                block = _merge(self._blocks[-self._pending:], dedupe=False)
                self._blocks[-self._pending:] = [block]
            self._pending = 0
            entries = self._entries(block)
            self._publish(entries, rebuild=False)
            if entries is not None:
                self._n_flushes += 1
                self.delta_flushes += 1

    def _ensure_built(self) -> None:
        snap = self._snap
        if not (self._needs_rebuild or self._n_flushes >= REBUILD_FLUSHES
                or self._pending or snap.n_docs != self._n_docs
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
        """The JAX package's JSON: terms by id, each term's rows (and the
        documents) in the order they were first added."""
        with self._mutate_lock:
            block = _merge(self._blocks, dedupe=self._upserted)
            bounds = np.searchsorted(
                block.tid, np.arange(self.n_terms + 1)).tolist()
            rows, tfs = block.row.tolist(), block.tf.tolist()
            docs = np.flatnonzero(self._lens >= 0)
            docs = docs[np.argsort(self._seq[docs], kind="stable")]
            state = {
                "k1": self.k1, "b": self.b, "stemming": self.stemming,
                "terms": self._term_ids,
                "postings": [dict(zip(map(str, rows[lo:hi]), tfs[lo:hi]))
                             for lo, hi in zip(bounds[:-1], bounds[1:])],
                "doc_len": dict(zip(map(str, docs.tolist()),
                                    self._lens[docs].tolist())),
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(state, f)

    @classmethod
    def load(cls, path: str, *, device=None) -> "BM25Index":
        with open(path) as f:
            state = json.load(f)
        idx = cls(k1=state["k1"], b=state["b"], stemming=state["stemming"],
                  device=device)
        terms = {t: int(i) for t, i in state["terms"].items()}
        postings, doc_len = state["postings"], state["doc_len"]
        if sorted(terms.values()) != list(range(len(terms))) or \
                len(postings) != len(terms):
            raise ValueError(f"{path}: term ids are not 0..n-1 with one "
                             "postings list each")
        per_term = np.fromiter(map(len, postings), np.int64, len(postings))
        total = int(per_term.sum())
        rows = np.fromiter((int(r) for p in postings for r in p), np.int64,
                           total)
        tfs = np.fromiter((int(f) for p in postings for f in p.values()),
                          np.int32, total)
        docs = np.fromiter(map(int, doc_len), np.int64, len(doc_len))
        lens = np.fromiter(map(int, doc_len.values()), np.int32, len(docs))
        every = np.concatenate([rows, docs])
        if len(every) and (every.min() < 0 or every.max() >= 2 ** 31):
            raise ValueError(f"{path}: rows must lie in [0, 2**31)")
        idx._term_ids = terms
        idx._grow_rows(int(every.max()) + 1 if len(every) else 0)
        idx._lens[docs] = lens
        idx._seq[docs] = np.arange(len(docs))
        idx._n_seq = idx._n_docs = len(docs)
        idx._len_sum = int(lens.sum())
        tid = np.repeat(np.arange(len(terms), dtype=np.int32), per_term)
        idx._df = np.bincount(tid, minlength=len(terms))
        if total:
            idx._blocks = [_Block(tid, rows.astype(np.int32), tfs)]
        return idx
