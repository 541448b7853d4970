"""Hot-tail segmented index: O(tail) appends under query load.

Counterpart of ``archi_tpu/engine/segmented_index.py``.  ``FlatIndex``
appends fill new buffers (snapshot isolation for concurrent readers), which
costs one full-capacity device copy per batch.  ``SegmentedFlatIndex``
keeps a small hot TAIL segment that absorbs appends (copies are O(tail
capacity)) and merges into the cold MAIN segment only every ``merge_rows``
rows — one O(main) copy amortized over many batches.

Correctness invariants:
- GLOBAL row numbering is stable across merges: main owns rows
  [0, n_merged), the tail's physical row i is global ``n_merged + i``, and
  a merge writes the tail block at main offset ``n_merged`` — positions
  never move, so caller-built per-row vectors (BM25 bias, filter masks,
  tombstones) stay aligned.
- A search may race a merge; segments are searched tail-FIRST, so a row is
  observed in the old tail, the new main, or both — never neither.  The
  k-merge dedupes by global row (duplicates carry identical scores).  A
  merge epoch counter retries the (rare) case where a merge completes
  between reading ``n_merged`` and snapshotting the tail.
- Tombstones, ids, and dead counts transfer exactly at merge (raw buffer
  block copy + bookkeeping shift — rows are NOT re-normalized or
  re-quantized).

Both segments are scanned by the fused top-k (``FlatIndex.search_dispatch``;
the tail keeps one static shape, pre-sized to ``merge_rows``); the k-merge
and the dedupe run on the host, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np
import torch

from archi_tpu_torch.engine.flat_index import FlatIndex


class _GlobalIdRows:
    """Dict-like view of id → [global rows] over both segments."""

    def __init__(self, idx: "SegmentedFlatIndex"):
        self._idx = idx

    def get(self, key, default=None):
        rows = list(self._idx.main._id_rows.get(key, ()))
        shift = self._idx.n_merged
        rows.extend(r + shift for r in self._idx.tail._id_rows.get(key, ()))
        return rows if rows else default

    def __contains__(self, key) -> bool:
        return (key in self._idx.main._id_rows
                or key in self._idx.tail._id_rows)

    def pop(self, key, default=None):
        rows = self.get(key, default)
        self._idx.main._id_rows.pop(key, None)
        self._idx.tail._id_rows.pop(key, None)
        return rows

    def keys(self):
        # union preserving main-then-tail order; the store's ids() /
        # diff-sync iterate this (a tail-only chunk must not be invisible
        # to the hash diff or it re-embeds every sync)
        seen = dict.fromkeys(self._idx.main._id_rows)
        seen.update(dict.fromkeys(self._idx.tail._id_rows))
        return list(seen)

    def __iter__(self):
        return iter(self.keys())


class SegmentedFlatIndex:
    """FlatIndex-compatible surface over a cold MAIN + hot TAIL segment."""

    #: the segment slice cuts the row axis of [N] or [B, N] bias alike, and
    #: both segments are FlatIndexes — batched hybrid runs fused
    supports_batched_bias = True

    def __init__(self, dim: int, *, dtype=torch.bfloat16, tile_n: int = 4096,
                 normalize: bool = True, metric: str = "cosine",
                 merge_rows: int = 1 << 16, tail_tile_n: int = 512,
                 device=None):
        self.main = FlatIndex(dim, dtype=dtype, tile_n=tile_n,
                              normalize=normalize, metric=metric,
                              device=device)
        self.merge_rows = int(merge_rows)
        self.tail = self._fresh_tail(dim, self.main.dtype, tail_tile_n,
                                     normalize, metric)
        self._lock = threading.RLock()
        self._merge_epoch = 0

    def _fresh_tail(self, dim, dtype, tile_n, normalize, metric) -> FlatIndex:
        t = FlatIndex(dim, dtype=dtype, tile_n=tile_n, normalize=normalize,
                      metric=metric, device=self.main.device)
        # pre-size to the merge threshold: the tail keeps ONE shape for its
        # whole lifetime (merges write it as one static block)
        t._grow_to(self.merge_rows)
        return t

    # -------------------------------------------------- FlatIndex surface
    @property
    def dim(self) -> int:
        return self.main.dim

    @property
    def dtype(self):
        return self.main.dtype

    @property
    def device(self) -> torch.device:
        return self.main.device

    @property
    def tile_n(self) -> int:
        return self.main.tile_n

    @property
    def normalize(self) -> bool:
        return self.main.normalize

    @property
    def n_merged(self) -> int:
        return self.main.n_rows

    @property
    def n_rows(self) -> int:
        return self.main.n_rows + self.tail.n_rows

    @property
    def capacity(self) -> int:
        # upper bound for caller-built per-global-row vectors
        return self.main.capacity + self.tail.capacity

    @property
    def alive(self) -> torch.Tensor:
        """[capacity] liveness aligned to GLOBAL rows (the bm25-only ranking
        path builds its bias from this)."""
        nm = self.n_merged
        parts = [self.main.alive[:nm], self.tail.alive]
        used = nm + self.tail.capacity
        if used < self.capacity:
            parts.append(torch.zeros((self.capacity - used,),
                                     dtype=torch.float32, device=self.device))
        return torch.cat(parts)

    @property
    def _id_rows(self):
        return _GlobalIdRows(self)

    @property
    def _n_dead(self) -> int:
        return self.main._n_dead + self.tail._n_dead

    def __len__(self) -> int:
        return len(self.main) + len(self.tail)

    def _global_id(self, row: int):
        if row < self.n_merged:
            ids = self.main._ids
            return ids[row] if row < len(ids) else None
        r = row - self.n_merged
        ids = self.tail._ids
        return ids[r] if r < len(ids) else None

    # ----------------------------------------------------------------- write
    def add(self, embeddings, ids: Sequence[Any]) -> list[int]:
        with self._lock:
            base = self.n_merged
            rows = self.tail.add(embeddings, ids)
            out = [base + r for r in rows]
            if self.tail.n_rows >= self.merge_rows:
                self.merge()
            return out

    def merge(self) -> None:
        """Fold the tail into the main segment (one O(main) copy)."""
        with self._lock:
            t = self.tail
            n_t = t.n_rows
            if n_t == 0:
                return
            m = self.main
            offset = m.n_rows
            # raw block transfer: stored rows + alive (tombstones) verbatim;
            # the whole tail-capacity buffer is written (padding rows are
            # dead and land on main padding), keeping the write shape static
            block, alive_block = t.emb, t.alive
            m._grow_to(offset + block.shape[0])
            # the ids first: a search that sees the new n_rows finds them
            m._ids.extend(t._ids[:n_t])
            for i, rows in t._id_rows.items():
                m._id_rows.setdefault(i, []).extend(r + offset for r in rows)
            m._write_block(block, alive_block, offset, offset + n_t)
            m._n_dead += t._n_dead
            self.tail = self._fresh_tail(t.dim, t.dtype, t.tile_n,
                                         t.normalize, t.metric)
            self._merge_epoch += 1

    def delete(self, ids: Sequence[Any]) -> int:
        with self._lock:
            return self.main.delete(ids) + self.tail.delete(ids)

    def compact(self) -> None:
        with self._lock:
            self.merge()
            self.main.compact()

    # ---------------------------------------------------------------- search
    def search(self, queries, k: int = 10, *, filter_mask=None, bias=None):
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]

        def seg_vec(vec, start: int, seg_cap: int):
            # row-vector [N] or per-query [B, N] (batched hybrid), numpy or
            # tensor: the segment slice is always along the LAST (row) axis
            return None if vec is None else vec[..., start: start + seg_cap]

        # Launch BOTH segment scans before reading either back.
        for _attempt in range(8):
            epoch0 = self._merge_epoch
            nm = self.n_merged
            tail = self.tail
            # tail FIRST: a racing merge duplicates rows (deduped below)
            # rather than dropping them
            t_vals, t_rows = tail.search_dispatch(
                q, k, filter_mask=seg_vec(filter_mask, nm, tail.capacity),
                bias=seg_vec(bias, nm, tail.capacity))
            if self._merge_epoch == epoch0:
                break
        m_vals, m_rows = self.main.search_dispatch(
            q, k, filter_mask=seg_vec(filter_mask, 0, self.main.capacity),
            bias=seg_vec(bias, 0, self.main.capacity))
        vals = torch.cat([m_vals, t_vals], dim=1).cpu().numpy()
        rows = torch.cat([m_rows.long(), t_rows.long() + nm],
                         dim=1).cpu().numpy()
        b = q.shape[0]
        k_eff = min(k, vals.shape[1])
        out_ids, out_vals, out_rows = [], [], []
        for qi in range(b):
            order = np.argsort(-vals[qi], kind="stable")
            seen: set[int] = set()
            ids_q, vals_q, rows_q = [], [], []
            for j in order:
                r = int(rows[qi, j])
                v = float(vals[qi, j])
                if r in seen:
                    continue  # merge-race duplicate (identical score)
                seen.add(r)
                ids_q.append(self._global_id(r) if v > -1e29 else None)
                vals_q.append(v)
                rows_q.append(r)
                if len(rows_q) == k_eff:
                    break
            out_ids.append(ids_q)
            out_vals.append(vals_q)
            out_rows.append(rows_q)
        return (out_ids, np.asarray(out_vals, np.float32),
                np.asarray(out_rows, np.int64))

    # ------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        with self._lock:
            self.merge()
            self.main.save(path)

    @classmethod
    def load(cls, path: str, *, device=None, **kw) -> "SegmentedFlatIndex":
        main = FlatIndex.load(path, device=device)
        idx = cls(main.dim, dtype=main.dtype, tile_n=main.tile_n,
                  normalize=main.normalize, metric=main.metric,
                  device=main.device, **kw)
        idx.main = main
        return idx
