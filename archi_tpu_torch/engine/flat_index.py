"""Device-resident flat (exact) vector index.

Counterpart of ``archi_tpu/engine/flat_index.py``.  The corpus lives as a
padded device tensor ``[capacity, D]`` scanned by the fused top-k kernel
(``archi_tpu_torch.ops.topk``) — exact search.

- **Capacity** is a power of two >= ``MIN_CAPACITY`` (and >= ``tile_n``,
  kept so that both packages size and checkpoint the index alike); an
  append of n rows reserves room for its write bucket, as the JAX package's
  bucketed writes do.
- **Deletes are tombstones** (an ``alive`` mask turned into a NEG_INF
  bias); ``compact()`` reclaims space.
- **Snapshot isolation**: a write never touches a buffer a reader may hold.
  Every append or delete fills a NEW buffer and swaps it in under
  ``_buf_lock``, so a search running concurrently with ingest reads a
  consistent (emb, alive, n_rows) snapshot; the old buffer lives until its
  last reader drops it.  Cost: one device copy per append batch.
- ``save``/``load`` use the JAX package's npz layout, so a checkpoint
  written by either package loads in the other.
"""

from __future__ import annotations

import json
import numbers
import os
import threading
from typing import Any, Sequence

import numpy as np
import torch

from archi_tpu_torch.engine.topk import alive_to_bias, pad_bias_rows, topk_scores
from archi_tpu_torch.ops.topk import quantize_int8
from archi_tpu_torch.utils.hardware import default_device
from archi_tpu_torch.utils.tracing import span

MIN_CAPACITY = 1024
_WRITE_BUCKETS = (256, 1024, 4096, 16384, 65536)

#: storage dtypes by the names the npz checkpoint records
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int8": torch.int8}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its checkpoint name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in DTYPES:
        raise ValueError(f"unsupported index dtype {dtype!r}; "
                         f"expected one of {sorted(DTYPES)}")
    return DTYPES[str(dtype)]


def dtype_name(dtype: torch.dtype) -> str:
    return next(name for name, dt in DTYPES.items() if dt == dtype)


def _round_capacity(n: int, tile_n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return max(cap, tile_n)


def _bucket(n: int) -> int:
    for b in _WRITE_BUCKETS:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


def load_npz(path):
    """np.load that tolerates the extension np.savez appends on save."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    return np.load(path, allow_pickle=False)


def jsonable_ids(ids):
    """Serialize row ids preserving int/str types (numpy integers land as
    ints), so delete-by-id keeps working after a reload."""
    return [
        i if (i is None or isinstance(i, (str, int)))
        else int(i) if isinstance(i, numbers.Integral)
        else str(i)
        for i in ids
    ]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


class FlatIndex:
    """Exact cosine/IP index over a padded device tensor."""

    #: ``search`` takes a per-query [B, N] bias (batched hybrid)
    supports_batched_bias = True

    def __init__(self, dim: int, *, dtype=torch.bfloat16, tile_n: int = 4096,
                 normalize: bool = True, metric: str = "cosine", device=None):
        self.dim = int(dim)
        self.dtype = as_dtype(dtype)
        self.tile_n = int(tile_n)
        self.normalize = bool(normalize) and metric == "cosine"
        self.metric = metric
        self.device = default_device(device)
        # guards (emb, alive, n_rows, capacity) swaps
        self._buf_lock = threading.Lock()
        self._reset_buffers()

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return self.n_rows - self._n_dead

    # ----------------------------------------------------------------- write
    def _grow_to(self, n: int) -> None:
        """Grow the capacity to hold ``n`` rows (new zero-padded buffers,
        swapped in under ``_buf_lock``)."""
        new_cap = _round_capacity(n, self.tile_n)
        if new_cap <= self.capacity:
            return
        new_emb = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                              device=self.device)
        new_alive = torch.zeros((new_cap,), dtype=torch.float32,
                                device=self.device)
        with self._buf_lock:
            new_emb[:self.capacity] = self.emb
            new_alive[:self.capacity] = self.alive
            self.emb, self.alive, self.capacity = new_emb, new_alive, new_cap

    def _write_block(self, block: torch.Tensor, alive_block: torch.Tensor,
                     offset: int, n_rows: int) -> None:
        """Write raw stored rows (already in the index's dtype) and their
        liveness at ``offset`` into NEW buffers and swap them in together
        with ``n_rows`` under ``_buf_lock``: a concurrent search sees the
        old (emb, alive, n_rows) or the new one, never a mix.  The block
        must fit the current capacity (``_grow_to`` first)."""
        end = offset + block.shape[0]
        if end > self.capacity:
            raise ValueError(f"block rows [{offset}, {end}) exceed the "
                             f"capacity {self.capacity}")
        with self._buf_lock:
            new_emb, new_alive = self.emb.clone(), self.alive.clone()
            new_emb[offset:end] = block.to(self.device, self.dtype)
            new_alive[offset:end] = alive_block.to(self.device, torch.float32)
            self.emb, self.alive, self.n_rows = new_emb, new_alive, n_rows

    def add(self, embeddings, ids: Sequence[Any]) -> list[int]:
        """Append embeddings ([n, D] numpy or tensor); returns assigned
        physical rows."""
        x = torch.as_tensor(embeddings).to(self.device, torch.float32)
        n = x.shape[0]
        if x.shape != (n, self.dim) or len(ids) != n:
            raise ValueError(f"add: embeddings {tuple(x.shape)} with "
                             f"{len(ids)} ids, index dim {self.dim}")
        if n == 0:
            return []
        if self.normalize:
            x = l2_normalize(x)
        # symmetric int8 of unit-norm rows: round(127 x)
        x = quantize_int8(x) if self.dtype == torch.int8 else x.to(self.dtype)

        offset = self.n_rows
        cap = max(self.capacity, _round_capacity(offset + n, self.tile_n))
        if offset + _bucket(n) > cap:
            # room for the whole write bucket, as in the JAX package
            cap = _round_capacity(offset + _bucket(n), self.tile_n)
        # fill NEW buffers (rows past n_rows are zero); readers keep the old
        new_emb = torch.zeros((cap, self.dim), dtype=self.dtype,
                              device=self.device)
        new_alive = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        new_emb[:offset] = self.emb[:offset]
        new_alive[:offset] = self.alive[:offset]
        new_emb[offset:offset + n] = x
        new_alive[offset:offset + n] = 1.0
        with self._buf_lock:
            self.emb, self.alive, self.capacity = new_emb, new_alive, cap
        rows = list(range(offset, offset + n))
        self._ids.extend(ids)
        for r, i in zip(rows, ids):
            self._id_rows.setdefault(i, []).append(r)
        self.n_rows += n
        return rows

    def delete(self, ids: Sequence[Any]) -> int:
        """Tombstone all rows belonging to the given chunk ids."""
        rows: list[int] = []
        for i in ids:
            rows.extend(self._id_rows.pop(i, []))
        if not rows:
            return 0
        new_alive = self.alive.clone()  # readers keep the old mask
        new_alive[torch.as_tensor(rows, dtype=torch.long,
                                  device=self.device)] = 0.0
        with self._buf_lock:
            self.alive = new_alive
        for r in rows:
            self._ids[r] = None
        self._n_dead += len(rows)
        return len(rows)

    def _reset_buffers(self) -> None:
        """Fresh empty buffers at minimum capacity."""
        cap = _round_capacity(MIN_CAPACITY, self.tile_n)
        emb = torch.zeros((cap, self.dim), dtype=self.dtype, device=self.device)
        alive = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        with self._buf_lock:
            self.emb, self.alive, self.capacity = emb, alive, cap
        self.n_rows = 0
        self._ids: list = []
        self._id_rows: dict = {}
        self._n_dead = 0

    def _rows_f32(self, n: int) -> torch.Tensor:
        """The first n stored rows as f32 (int8 dequantised by 1/127)."""
        emb = self.emb[:n].float()
        return emb / 127.0 if self.dtype == torch.int8 else emb

    def compact(self) -> None:
        """Physically drop tombstoned rows."""
        if self._n_dead == 0:
            return
        keep = [r for r in range(self.n_rows) if self._ids[r] is not None]
        ids = [self._ids[r] for r in keep]
        emb = self._rows_f32(self.n_rows)[
            torch.as_tensor(keep, dtype=torch.long, device=self.device)]
        self._reset_buffers()
        if ids:
            # rows were normalized already; bypass re-normalization
            saved = self.normalize
            self.normalize = False
            self.add(emb, ids)
            self.normalize = saved

    # ---------------------------------------------------------------- search
    def search_dispatch(self, queries, k: int = 10, *, filter_mask=None,
                        bias=None):
        """Run the scan and return DEVICE (vals [B, k], rows [B, k])."""
        with span("index.dispatch") as s:
            # a copy from host memory: on the card it waits for the stream
            on_host = not (torch.is_tensor(queries)
                           and queries.device == self.device)
            with span("index.upload", wait=on_host):
                q = torch.as_tensor(queries).to(self.device, torch.float32)
                fm = (None if filter_mask is None else torch.as_tensor(
                    filter_mask).to(self.device, torch.float32))
            if q.dim() == 1:
                q = q[None, :]
            if self.normalize:
                q = l2_normalize(q)
            with self._buf_lock:  # consistent (emb, alive, n_rows) snapshot
                emb_snap, alive_snap, n_rows_snap = (
                    self.emb, self.alive, self.n_rows)
            cap = alive_snap.shape[0]
            alive = alive_snap
            if fm is not None:
                alive = alive * pad_bias_rows(fm, cap)
            row_bias = alive_to_bias(alive)
            if bias is not None:
                # [N] shared or [B, N] per-query (batched hybrid); broadcasts
                b = torch.as_tensor(bias).to(self.device, torch.float32)
                row_bias = row_bias + pad_bias_rows(b, cap)
            if s.recording:
                s.set(batch=int(q.shape[0]), live=int(n_rows_snap),
                      bias="none" if bias is None else
                      "per_query" if row_bias.dim() == 2 else "shared")
            k_eff = min(k, max(len(self), 1))
            return topk_scores(q, emb_snap, row_bias, n_rows_snap, k=k_eff)

    def search(self, queries, k: int = 10, *, filter_mask=None, bias=None):
        """Top-k search.

        Args:
          queries: [B, D] or [D].
          filter_mask: optional [capacity] (or [n_rows]) 0/1 float mask.
          bias: optional [capacity] or [B, capacity] additive f32 per-row
            score bias (``bm25_weight * bm25`` in hybrid search).
        Returns:
          (ids: list[list[chunk_id]], scores [B, k] np.f32, rows [B, k]).
        """
        vals, rows = self.search_dispatch(queries, k, filter_mask=filter_mask,
                                          bias=bias)
        with span("index.readback", wait=True):
            vals = vals.cpu().numpy()
            rows = rows.cpu().numpy()
        ids = [
            [self._ids[r] if (v > -1e29 and r < len(self._ids)) else None
             for r, v in zip(rr, vv)]
            for rr, vv in zip(rows, vals)
        ]
        return ids, vals, rows

    # ------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        """The JAX package's npz layout (f32 rows, alive, meta), written
        uncompressed: compressing embedding rows saves little space and
        costs minutes at millions of rows.  ``np.load`` reads either."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path,
            emb=self._rows_f32(self.n_rows).cpu().numpy(),
            alive=self.alive[: self.n_rows].cpu().numpy(),
            meta=json.dumps(
                {
                    "dim": self.dim,
                    "dtype": dtype_name(self.dtype),
                    "tile_n": self.tile_n,
                    "metric": self.metric,
                    "ids": jsonable_ids(self._ids),
                }
            ),
        )

    @classmethod
    def load(cls, path: str, *, device=None, **extra) -> "FlatIndex":
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        idx = cls(meta["dim"], dtype=meta["dtype"], tile_n=meta["tile_n"],
                  metric=meta["metric"], device=device, **extra)
        emb = z["emb"]
        alive = z["alive"]
        ids = meta["ids"]
        keep = alive > 0.5
        if keep.any():
            saved = idx.normalize
            idx.normalize = False
            idx.add(emb[keep], [i for i, kp in zip(ids, keep) if kp])
            idx.normalize = saved
        return idx
