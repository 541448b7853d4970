"""Host-side full-precision vector tier: the exact-rerank companion to the
PQ indexes.

Counterpart of ``archi_tpu/engine/host_store.py`` (numpy, copied).  At PQ
scale the card holds only codes; the full vectors live where capacity is
cheap — host RAM or disk via ``numpy.memmap``.  Searches run on the device
over codes; the host tier only gathers the final top-C candidates (C ~ tens)
and re-scores them exactly — O(C·D) per query, no scan.

numpy has no bfloat16 (the JAX package stores its XL plane through
``ml_dtypes``): ``dtype=BF16`` keeps the raw bf16 bit patterns in a
``uint16`` buffer, rounded to nearest even as ``ml_dtypes`` rounds, and
every read upcasts them by ``bits << 16``.  A plane file written by either
package therefore reads back bit for bit in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

#: ``HostVectorStore`` dtype of a bf16 plane held as raw bits
BF16 = "bfloat16"


def f32_to_bf16_bits(x) -> np.ndarray:
    """f32 → bf16 bit patterns (uint16), rounded to nearest even; NaN stays a
    quiet NaN of the same sign, overflow rounds to inf (``ml_dtypes``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(np.asarray(x, np.float32))
    if nan.any():
        bits[nan] = ((u[nan] >> 16) & 0x8000) | 0x7FC0
    return bits


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bf16 bit patterns (uint16) → f32, exactly (``bits << 16``)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


class HostVectorStore:
    """Append-only [N, D] f16 row store, RAM- or disk-backed.

    path=None → in-RAM ndarray (tests, small corpora).  With a path, rows
    live in a memmap that survives restarts; ``meta.json`` tracks the row
    count for reopening.  ``dtype=BF16`` stores bf16 bit patterns (``dtype``
    is then ``uint16``, the buffer's type, and ``bf16`` is True).
    """

    def __init__(self, dim: int, *, path: str | None = None,
                 capacity: int = 1 << 15, dtype=np.float16):
        self.dim = int(dim)
        self.path = path
        self.bf16 = isinstance(dtype, str) and dtype == BF16
        self.dtype = np.dtype(np.uint16 if self.bf16 else dtype)
        self._n = 0
        self._cap = max(int(capacity), 1024)
        if path is None:
            self._buf = np.zeros((self._cap, self.dim), self.dtype)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            meta = path + ".meta.json"
            if os.path.exists(path) and os.path.exists(meta):
                with open(meta) as f:
                    m = json.load(f)
                self._n = int(m["n_rows"])
                self._cap = max(self._cap, int(m["capacity"]))
                assert int(m["dim"]) == self.dim, "dim mismatch on reopen"
                self._buf = np.memmap(path, dtype=self.dtype, mode="r+",
                                      shape=(self._cap, self.dim))
            else:
                self._buf = np.memmap(path, dtype=self.dtype, mode="w+",
                                      shape=(self._cap, self.dim))
                self._write_meta()

    def _write_meta(self) -> None:
        if self.path is not None:
            with open(self.path + ".meta.json", "w") as f:
                json.dump({"n_rows": self._n, "capacity": self._cap,
                           "dim": self.dim}, f)

    def __len__(self) -> int:
        return self._n

    def _grow_to(self, need: int) -> None:
        new_cap = self._cap
        while new_cap < need:
            new_cap *= 2
        if new_cap == self._cap:
            return
        if self.path is None:
            grown = np.zeros((new_cap, self.dim), self.dtype)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown
        else:
            # grow the backing FILE in place and remap read-write: no
            # in-RAM snapshot of the store (77 GB at the design scale) and
            # no truncate-then-rewrite window that a crash would turn into
            # total data loss
            self._buf.flush()
            del self._buf
            with open(self.path, "r+b") as f:
                f.truncate(new_cap * self.dim * self.dtype.itemsize)
            self._buf = np.memmap(self.path, dtype=self.dtype, mode="r+",
                                  shape=(new_cap, self.dim))
        self._cap = new_cap
        self._write_meta()

    def add(self, x) -> np.ndarray:
        """Append rows → their row numbers (aligned with the device index's
        physical rows when fed from the same ingest stream)."""
        x = np.asarray(x)
        n_new = x.shape[0]
        self._grow_to(self._n + n_new)
        if self.bf16:
            self._buf[self._n: self._n + n_new] = f32_to_bf16_bits(x)
        elif x.dtype == self.dtype:
            # same-dtype fast path: straight memcpy into the store. The
            # f32 round-trip below allocates 2x the block in fresh pages,
            # whose first-touch faults dominate a bulk fill.
            self._buf[self._n: self._n + n_new] = x
        else:
            self._buf[self._n: self._n + n_new] = \
                np.asarray(x, np.float32).astype(self.dtype)
        rows = np.arange(self._n, self._n + n_new)
        self._n += n_new
        self._write_meta()
        return rows

    def get(self, rows) -> np.ndarray:
        """Gather rows (negative/dead ids → zero vectors) → [len, D] f32."""
        rows = np.asarray(rows, np.int64)
        safe = np.clip(rows, 0, max(self._n - 1, 0))
        out = self.to_f32(self._buf[safe])
        out[rows < 0] = 0.0
        return out

    def to_f32(self, raw) -> np.ndarray:
        """Stored rows (a slice or gather of the buffer) → f32."""
        if self.bf16:
            return bf16_bits_to_f32(raw)
        return np.asarray(raw, np.float32)

    def flush(self) -> None:
        if self.path is not None:
            self._buf.flush()
            self._write_meta()


def mark_duplicate_rows(rows: np.ndarray) -> np.ndarray:
    """[B, C] candidate row ids (columns in descending preference order)
    → bool [B, C] marking every occurrence AFTER THE FIRST of each
    non-negative row.  The stable argsort visits equal rows in column
    order, so the kept copy is the earliest = best-preferred one.
    Shared by ``exact_rerank`` and the spilled ADC-only path in
    ``IVFPQIndex.search``."""
    srt = np.argsort(rows, axis=1, kind="stable")
    rs = np.take_along_axis(rows, srt, axis=1)
    dup_s = np.zeros_like(rs, dtype=bool)
    dup_s[:, 1:] = (rs[:, 1:] == rs[:, :-1]) & (rs[:, 1:] >= 0)
    dup = np.zeros_like(dup_s)
    np.put_along_axis(dup, srt, dup_s, axis=1)
    return dup


def exact_rerank(store: HostVectorStore, queries, vals, rows, *, k: int,
                 bias=None):
    """Re-score candidate rows with exact inner products from the host tier.

    queries [B, D] (normalized, pre-scaled for hybrid); vals/rows [B, C]
    from the ANN (NEG_INF = dead, stays dead); bias: optional f32 by row —
    [N] shared or [B, N] per-query (batched hybrid; the finite part rides
    into the exact score; tombstones are already NEG_INF in vals).
    → (vals [B, k], rows [B, k]).
    """
    queries = np.asarray(queries, np.float32)
    vals = np.asarray(vals, np.float32)
    rows = np.asarray(rows, np.int64)
    b, c = rows.shape
    flat = store.get(rows.reshape(-1)).reshape(b, c, -1)     # [B, C, D]
    # batched matvec (BLAS gemv per row) measured ~1.3x faster than the
    # einsum contraction on the single-core host
    exact = np.matmul(flat, queries[:, :, None])[..., 0]     # [B, C]
    if bias is not None:
        bias = np.asarray(bias, np.float32)
        safe = np.clip(rows, 0, bias.shape[-1] - 1)
        if bias.ndim == 2:
            picked = np.take_along_axis(bias, safe, axis=1)  # [B, C]
        else:
            picked = bias[safe]
        exact = exact + np.where(rows >= 0, picked, 0.0)
    scores = np.where(vals > -1e29, exact, vals)
    # a spilled index (IVFPQIndex build_streaming spill_frac>0) can emit
    # the same ORIGINAL row from two blocks; keep one copy per query so
    # duplicates never burn top-k slots
    scores = np.where(mark_duplicate_rows(rows), -np.inf, scores)
    kk = min(k, c)
    if kk < c // 2:
        # argpartition + small sort instead of a full C-wide argsort
        part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        top = np.take_along_axis(scores, part, axis=1)
        order = np.take_along_axis(part, np.argsort(-top, axis=1), axis=1)
    else:
        order = np.argsort(-scores, axis=1)[:, :kk]
    return (np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(rows, order, axis=1))
