"""Sharded XL serving tier: the beyond-device-memory index over devices.

Counterpart of ``archi_tpu/engine/sharded_xl.py``: S ``XlPQIndex`` shards,
one a device, with the full serving contract:

- **per-shard codes + fresh tail + tombstones**: each device owns an
  ``XlPQIndex`` whose host plane is its own (RAM or memmap); its snapshot
  probe runs the 4-bit ADC kernel and its fresh tail the fused top-k;
- **dense global rows**: rows are numbered in insertion order across the
  whole tier (the store's bias / filter / enablement contract is a vector
  indexed by global row); host maps route global row ↔ (shard, local row).
  A batch goes to the currently smallest shard, whole;
- **overlapped fan-out**: every shard's device work is launched first
  (``search_dispatch_parts``), fetched in one wait per device, then
  host-reranked per shard against that shard's plane and merged globally;
- **snapshot adopt across shards**: each shard refreshes its own snapshot
  from its own plane on its own growth schedule.

Per-shard results are exact inner products (host-reranked snapshot
candidates + exact tail), so the merge of per-shard top-k is the top-k of
the union of candidate sets.  ``save``/``load`` use the JAX package's file
layout (``<base>.shard{s}`` per shard plus the npz of ``shard_of`` /
``local_of`` / ``meta``), so a checkpoint of either package loads in the
other.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.engine.distributed import data_mesh, fetch
from archi_tpu_torch.engine.flat_index import jsonable_ids, load_npz
from archi_tpu_torch.engine.topk import NEG_INF
from archi_tpu_torch.engine.xl_index import XlPQIndex, _host


class ShardedXlPQIndex:
    supports_batched_bias = True

    def __init__(self, dim: int, *, devices=None, store_dir: str | None =
                 None, stores=None, normalize: bool = True,
                 snapshot_sources=None, **xl_kw):
        """``devices``: one shard on each (default: every visible CUDA
        device; a device may repeat).  ``store_dir``: per-shard host
        memmaps land there (``shard<j>.bf16``); None keeps every shard's
        plane in RAM.  ``stores``: pre-built per-shard ``HostVectorStore``s
        instead (e.g. zero-copy ``HostVectorStore.view`` windows over one
        big plane — pair with ``adopt_stores``).  ``snapshot_sources``:
        optional per-shard snapshot block providers.  ``xl_kw`` forwards
        to each shard's ``XlPQIndex`` (nlist, pq_m, nprobe_blocks,
        min_snapshot_rows, build_block_rows, ...)."""
        self.dim = int(dim)
        self.normalize = bool(normalize)
        self.devices = data_mesh(devices)
        self.device = self.devices[0]
        self.store_dir = store_dir
        if store_dir:
            os.makedirs(store_dir, exist_ok=True)
        if stores is not None:
            assert len(stores) == len(self.devices), \
                (len(stores), len(self.devices))
        self.shards: list[XlPQIndex] = []
        for j, dev in enumerate(self.devices):
            sp = (os.path.join(store_dir, f"shard{j}.bf16")
                  if store_dir else None)
            if stores is not None:
                xl_kw = dict(xl_kw, store=stores[j])
                sp = None
            if snapshot_sources is not None:
                xl_kw = dict(xl_kw, snapshot_source=snapshot_sources[j])
            # shards see pre-normalized rows and queries (one normalize at
            # the wrapper)
            self.shards.append(XlPQIndex(dim, store_path=sp, normalize=False,
                                         device=dev, **xl_kw))
        self._init_rows()

    def _init_rows(self) -> None:
        # dense global rows: insertion order across the tier, kept in
        # geometrically grown numpy buffers (valid prefix = n_rows /
        # _gcount[s])
        self._shard_of = np.zeros((0,), np.int32)    # global row -> shard
        self._local_of = np.zeros((0,), np.int64)    # global row -> local
        self._grows = [np.zeros((0,), np.int64) for _ in self.shards]
        self._gcount = [0 for _ in self.shards]      # valid prefix per shard
        self._alive_buf = np.zeros((0,), np.float32)
        self._ids: list = []                         # global row -> id
        self._id_rows: dict = {}                     # id -> [global rows]
        self._n_dead = 0

    def _global_rows(self, s: int) -> np.ndarray:
        return self._grows[s][:self._gcount[s]]

    @staticmethod
    def _grown(buf: np.ndarray, used: int, extra: int,
               fill=0) -> np.ndarray:
        if used + extra <= buf.shape[0]:
            return buf
        cap = max(used + extra, 2 * buf.shape[0], 1024)
        out = np.full((cap,), fill, buf.dtype)
        out[:used] = buf[:used]
        return out

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return len(self._ids) - self._n_dead

    @property
    def n_rows(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        return max(self.n_rows, 1)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def alive(self) -> torch.Tensor:
        """[capacity] f32 by GLOBAL row (pure-lexical ranking path)."""
        n = self.n_rows
        if n == 0:
            return torch.zeros((self.capacity,), dtype=torch.float32,
                               device=self.device)
        return torch.from_numpy(self._alive_buf[:n].copy()).to(self.device)

    # ----------------------------------------------------------------- write
    def _append_rows(self, s: int, local, ids) -> list[int]:
        """Global rows for ``ids`` appended to shard s at local rows
        ``local``."""
        n = len(ids)
        g0 = self.n_rows
        self._shard_of = self._grown(self._shard_of, g0, n)
        self._shard_of[g0:g0 + n] = s
        self._local_of = self._grown(self._local_of, g0, n)
        self._local_of[g0:g0 + n] = np.asarray(local, np.int64)
        gc = self._gcount[s]
        self._grows[s] = self._grown(self._grows[s], gc, n)
        self._grows[s][gc:gc + n] = np.arange(g0, g0 + n, dtype=np.int64)
        self._gcount[s] = gc + n
        self._alive_buf = self._grown(self._alive_buf, g0, n)
        self._alive_buf[g0:g0 + n] = 1.0
        self._ids.extend(ids)
        for j, i in enumerate(ids):
            self._id_rows.setdefault(i, []).append(g0 + j)
        return list(range(g0, g0 + n))

    def add(self, embeddings, ids: Sequence[Any]) -> list[int]:
        embeddings = _host(embeddings)
        n = embeddings.shape[0]
        assert len(ids) == n
        if n == 0:
            return []
        if self.normalize:
            embeddings = embeddings / np.maximum(
                np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
        # whole batch to the smallest shard: balanced over time, and the
        # shard's snapshot-refresh accounting sees one coherent append
        s = int(np.argmin([ix.n_rows for ix in self.shards]))
        local = self.shards[s].add(embeddings, ids)
        return self._append_rows(s, local, ids)

    def delete(self, ids: Sequence[Any]) -> int:
        grows: list[int] = []
        for i in ids:
            grows.extend(self._id_rows.pop(i, []))
        if not grows:
            return 0
        # each owning shard tombstones by id (snapshot bias + tail alive)
        for s in {int(self._shard_of[g]) for g in grows}:
            self.shards[s].delete(list(ids))
        for g in grows:
            self._ids[g] = None
        self._alive_buf[np.asarray(grows, np.int64)] = 0.0
        self._n_dead += len(grows)
        return len(grows)

    def refresh_snapshots(self) -> None:
        """Force a snapshot rebuild on every shard (adds trigger per-shard
        refresh automatically; this is the bulk-adopt hook)."""
        for shard in self.shards:
            shard.refresh_snapshot()

    def adopt_stores(self, ids_per_shard, *, refresh: bool = True) -> None:
        """Register pre-filled per-shard host planes (``XlPQIndex.
        adopt_store``): the bulk-load path for corpus shards sliced from
        one big plane by ``HostVectorStore.view``, no re-upload through
        ``add``.  Global rows are assigned shard-major in shard order; only
        on a fresh tier."""
        assert self.n_rows == 0, "adopt_stores requires a fresh tier"
        for s, ids in enumerate(ids_per_shard):
            self.shards[s].adopt_store(ids, refresh=refresh)
            self._append_rows(s, np.arange(len(ids)), list(ids))

    # ---------------------------------------------------------------- search
    def _slice_to_shard(self, vec, s: int, fill: float = 0.0):
        """Global-row vector ([N] or [B, N]) → shard s's local layout, on
        the vector's device; rows past the vector's length get ``fill``."""
        if vec is None:
            return None
        g_h = self._global_rows(s)
        g = torch.from_numpy(g_h.copy()).to(vec.device)
        local = torch.from_numpy(self._local_of[g_h]).to(vec.device)
        valid = g < vec.shape[-1]
        g, local = g[valid], local[valid]
        out = torch.full((*vec.shape[:-1], self.shards[s].n_rows), fill,
                         dtype=torch.float32, device=vec.device)
        out[..., local] = vec[..., g]
        return out

    def search(self, queries, k: int = 10, *, filter_mask=None, bias=None,
               nprobe_blocks: int | None = None,
               profile: dict | None = None):
        """``profile``: optional dict that receives per-phase wall times
        (``dispatch_s`` / ``fetch_s`` / ``rerank_s`` / ``merge_s``) plus
        ``fetch_bytes`` — the cross-shard traffic of the query."""
        _t0 = time.perf_counter()
        queries = _host(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.normalize:
            queries = queries / np.maximum(
                np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        b = queries.shape[0]
        fm = None if filter_mask is None else \
            torch.from_numpy(_host(filter_mask))
        ub = None if bias is None else \
            torch.as_tensor(bias).to(dtype=torch.float32)

        # phase 1: launch every shard's device work
        dispatched = []
        for s, shard in enumerate(self.shards):
            if shard.n_rows == 0:
                continue
            # short-mask convention (FlatIndex): rows past the global
            # mask's length are EXCLUDED — fill=0 keeps that per shard
            sfm = self._slice_to_shard(fm, s)
            sub = self._slice_to_shard(ub, s)
            parts, ctx = shard.search_dispatch_parts(
                queries, k, filter_mask=sfm, bias=sub,
                nprobe_blocks=nprobe_blocks)
            dispatched.append((s, parts, ctx))

        if not dispatched:
            vals = np.full((b, k), NEG_INF, np.float32)
            rows = np.full((b, k), -1, np.int64)
            return [[None] * k for _ in range(b)], vals, rows

        _t1 = time.perf_counter()
        # phase 2: one fetch across all shards
        flat = fetch([t for _s, parts, _c in dispatched for t in parts])
        _t2 = time.perf_counter()

        # phase 3: per-shard host rerank + local→global row mapping
        all_v, all_r = [], []
        i = 0
        for s, parts, ctx in dispatched:
            host_parts = flat[i:i + len(parts)]
            i += len(parts)
            sv, sr = self.shards[s].search_finalize_parts(ctx, host_parts)
            gmap = self._global_rows(s)
            ok = (sv > -1e29) & (sr >= 0) & (sr < gmap.shape[0])
            gr = np.where(ok, gmap[np.clip(sr, 0, gmap.shape[0] - 1)], -1)
            all_v.append(np.where(ok, sv, NEG_INF))
            all_r.append(gr)

        _t3 = time.perf_counter()
        av = np.concatenate(all_v, axis=1)
        ar = np.concatenate(all_r, axis=1)
        kk = min(k, av.shape[1])
        order = np.argsort(-av, axis=1)[:, :kk]
        vals = np.take_along_axis(av, order, axis=1)
        rows = np.take_along_axis(ar, order, axis=1)
        if kk < k:
            vals = np.pad(vals, ((0, 0), (0, k - kk)),
                          constant_values=NEG_INF)
            rows = np.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
        ids = [
            [self._ids[int(r)] if (v > -1e29 and 0 <= r < self.n_rows)
             else None
             for r, v in zip(rr, vv)]
            for rr, vv in zip(rows, vals)
        ]
        if profile is not None:
            profile.update(
                dispatch_s=_t1 - _t0, fetch_s=_t2 - _t1,
                rerank_s=_t3 - _t2,
                merge_s=time.perf_counter() - _t3,
                fetch_bytes=int(sum(a.nbytes for a in flat)))
        return ids, vals, rows

    # -------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        base = path[:-4] if path.endswith(".npz") else path
        for s, shard in enumerate(self.shards):
            shard.save(f"{base}.shard{s}")
        n = self.n_rows
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            shard_of=self._shard_of[:n], local_of=self._local_of[:n],
            meta=json.dumps({
                "dim": self.dim, "n_shards": self.n_shards,
                "ids": jsonable_ids(self._ids),
                "store_dir": self.store_dir,
                "normalize": self.normalize,
            }))

    @classmethod
    def load(cls, path: str, *, devices=None, **xl_kw) -> \
            "ShardedXlPQIndex":
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        base = path[:-4] if path.endswith(".npz") else path
        idx = cls.__new__(cls)
        idx.dim = meta["dim"]
        idx.normalize = bool(meta.get("normalize", True))
        idx.devices = data_mesh(devices)[:meta["n_shards"]]
        if len(idx.devices) != meta["n_shards"]:
            raise ValueError(
                f"checkpoint has {meta['n_shards']} shards; "
                f"{len(idx.devices)} devices available")
        idx.device = idx.devices[0]
        idx.store_dir = meta["store_dir"]
        idx.shards = [XlPQIndex.load(f"{base}.shard{s}", device=dev, **xl_kw)
                      for s, dev in enumerate(idx.devices)]
        idx._init_rows()
        idx._shard_of = np.asarray(z["shard_of"], np.int32)
        idx._local_of = np.asarray(z["local_of"], np.int64)
        # vectorized shard partition (a per-row Python loop is minutes of
        # work at the 10^8 rows this tier is for)
        idx._grows = [np.nonzero(idx._shard_of == s)[0].astype(np.int64)
                      for s in range(len(idx.shards))]
        idx._gcount = [g.shape[0] for g in idx._grows]
        ids = meta["ids"]
        idx._ids = list(ids)
        idx._alive_buf = np.fromiter((i is not None for i in ids),
                                     np.float32, count=len(ids))
        for g, i in enumerate(ids):
            if i is not None:
                idx._id_rows.setdefault(i, []).append(g)
        idx._n_dead = sum(1 for i in ids if i is None)
        return idx
