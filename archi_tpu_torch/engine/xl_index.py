"""XL serving index: corpora beyond device-memory scale with full serving
semantics.

Counterpart of ``archi_tpu/engine/xl_index.py``.  ``AnnFlatIndex`` keeps
the full-precision corpus on the card (its exact fresh-tail scan and device
rescore read it).  This index keeps only IVF-PQ codes on the card, the
full-precision rows in a host plane (``engine/host_store.py``, bf16 bits in
RAM or a memmap) and reranks the device's top-C candidates exactly on the
host:

- global row layout: the IVF-PQ snapshot covers rows ``[0, n_snap)``;
  rows added since live in a device-resident exact FRESH TAIL
  (``FlatIndex``), so recall never degrades with snapshot staleness;
- the host plane holds ALL rows and is the source of truth: snapshot
  rebuilds stream it back through the device encoder, and the exact
  rerank reads it;
- deletes tombstone everywhere at once (the snapshot's device bias + the
  tail's own alive) — a dead row can't resurface from any tier;
- hybrid BM25 bias / metadata filters / per-conversation enablement ride
  the same per-row additive-bias contract as every other index —
  including per-query [B, N] bias (micro-batched hybrid serving), which
  flows through all three tiers.  ANN caveat (shared with AnnFlatIndex):
  a positive bias rides the ADC scores of PROBED candidates; it cannot
  surface a snapshot row whose block the probe budget skipped (the tail
  is exact, so fresh rows always see their bias).

Searches: ADC block-budget probe over the snapshot (the 4-bit ADC kernel
on packed codes) → top-C candidates → host exact rescore; exact device
scan of the tail (the fused top-k); host merge.  Scores are exact inner
products end to end on the snapshot tier.

``save``/``load`` use the JAX package's layout (``index.npz`` +
``index.ivfpq.npz``; the plane embedded as f32 rows, or its memmap path),
so a checkpoint written by either package loads in the other.

Departure from the reference: ``snapshot_source`` is bounded by the plane
blocks it covered when it was injected; a refresh reads any block past that
coverage from the plane (the reference consults the provider for every
whole block, so growth by a whole block built the snapshot from rows the
provider never held).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.engine.flat_index import (FlatIndex, as_dtype,
                                               jsonable_ids, load_npz)
from archi_tpu_torch.engine.host_store import (BF16, HostVectorStore,
                                               exact_rerank)
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
from archi_tpu_torch.engine.pq import as_tensor
from archi_tpu_torch.engine.topk import NEG_INF, pad_bias_rows
from archi_tpu_torch.utils.hardware import default_device

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    """A host f32 array of a numpy array or a (device) tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def plane_rows(store: HostVectorStore, lo: int, hi: int, device):
    """Plane rows [lo, hi) as a device f32 tensor; a bf16 plane travels as
    its bits and is upcast on the device (exact)."""
    raw = np.array(store._buf[lo:hi])
    if store.bf16:
        return torch.from_numpy(raw.view(np.int16)).to(device).view(
            torch.bfloat16).float()
    return torch.from_numpy(store.to_f32(raw)).to(device)


class XlPQIndex:
    """Beyond-device-memory serving index (host plane + PQ snapshot + exact
    tail)."""

    # per-query [B, N] bias is supported on every tier: the snapshot's
    # block-layout bias, the host rerank's per-row pick, and the exact tail
    # — so micro-batched hybrid serving fuses here too.  The store's
    # BIAS_BUDGET splitter bounds the [B, N] footprint.
    supports_batched_bias = True

    def __init__(self, dim: int, *, store_path: Optional[str] = None,
                 store: Optional[HostVectorStore] = None,
                 nlist: int = 4096, block: int = 512,
                 pq_m: int = 48, pq_refine_m: int = 48, ksub: int = 16,
                 nprobe_blocks: int = 128, cell_gate: int | None = None,
                 block_rank_sub: int = 8, rerank_overfetch: int = 16,
                 extract: str = "auto", hier_t: int = 64,
                 pq_spill: float = 0.0, pq_opq_iters: int = 0,
                 min_snapshot_rows: int = 1 << 17,
                 refresh_fraction: float = 0.25,
                 build_block_rows: int = 1 << 17,
                 async_refresh: bool = False,
                 dtype=torch.bfloat16, tile_n: int = 4096,
                 normalize: bool = True, snapshot_source=None, device=None,
                 **_kw):
        self.dim = int(dim)
        self.dtype = as_dtype(dtype)
        self.tile_n = int(tile_n)
        self.normalize = bool(normalize)
        self.device = default_device(device)
        self.nlist = int(nlist)
        self.block = int(block)
        self.pq_m = int(pq_m)
        self.pq_refine_m = int(pq_refine_m)
        self.ksub = int(ksub)
        self.nprobe_blocks = int(nprobe_blocks)
        # two-level gate for block ranking (see IVFPQIndex cell_gate)
        self.cell_gate = None if cell_gate is None else int(cell_gate)
        # sub-block ranking granularity (see
        # IVFPQIndex.ensure_block_centroids)
        self.block_rank_sub = max(1, int(block_rank_sub))
        # stage-1 candidate extraction (see IVFPQIndex.search_dispatch)
        self.extract = str(extract)
        self.hier_t = int(hier_t)
        # snapshot build treatments (see IVFPQIndex.build_streaming)
        self.pq_spill = float(pq_spill)
        self.pq_opq_iters = int(pq_opq_iters)
        self.rerank_overfetch = int(rerank_overfetch)
        self.min_snapshot_rows = int(min_snapshot_rows)
        self.refresh_fraction = float(refresh_fraction)
        self.build_block_rows = int(build_block_rows)
        self.async_refresh = bool(async_refresh)

        self.store = store if store is not None else HostVectorStore(
            dim, path=store_path, dtype=BF16)
        self.snapshot_source = snapshot_source
        # fresh tail: device-exact; holds rows [n_snap, n_rows) with the
        # SAME chunk ids (its physical row r = global n_snap + r)
        self.tail = FlatIndex(dim, dtype=self.dtype, tile_n=tile_n,
                              normalize=False,  # rows pre-normalized here
                              device=self.device)
        self._ivf: Optional[IVFPQIndex] = None
        self._n_snap = 0
        # snapshot-tier tombstones as a device additive bias [n_snap]
        # (0 = alive, NEG_INF = dead); rebuilt at each snapshot adoption
        self._snap_bias = torch.zeros((0,), dtype=torch.float32,
                                      device=self.device)
        self._ids: list = []          # global row -> chunk id (None = dead)
        self._id_rows: dict = {}      # chunk id -> [global rows]
        self._n_dead = 0
        self._lock = threading.Lock()          # guards snapshot swaps
        self._build_lock = threading.Lock()    # serializes rebuilds
        self._refresh_thread: Optional[threading.Thread] = None
        # health signal: consecutive snapshot-refresh failures (serving
        # stays correct on the stale snapshot + exact tail, but the tail
        # grows while this climbs; a successful refresh resets it)
        self.refresh_failures = 0

    # -------------------------------------------------------- snapshot source
    @property
    def snapshot_source(self):
        """Optional out-of-band snapshot block provider: maps snapshot block
        i to a device array holding plane rows ``[i*build_block_rows,
        (i+1)*build_block_rows)`` (bit-identical when upcast to f32), so a
        bulk restore can rebuild without uploading the plane.  Injected at
        run time, not serialized; it serves only the whole blocks the plane
        held when it was injected."""
        return self._snapshot_source

    @snapshot_source.setter
    def snapshot_source(self, source) -> None:
        self._snapshot_source = source
        self._source_blocks = (0 if source is None
                               else len(self.store) // self.build_block_rows)

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return self.n_rows - self._n_dead

    @property
    def n_rows(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        # host-plane capacity: masks/bias vectors are sized to this
        return max(self.n_rows, 1)

    @property
    def alive(self) -> torch.Tensor:
        """[capacity] device f32 (protocol: pure-lexical ranking path)."""
        cap = self.capacity
        with self._lock:
            snap_bias, n_snap, tail = self._snap_bias, self._n_snap, self.tail
        snap_alive = (snap_bias[:min(n_snap, cap)] > NEG_INF / 2).float()
        n_tail = max(0, min(self.n_rows - n_snap, cap))
        return pad_bias_rows(torch.cat([snap_alive, tail.alive[:n_tail]]),
                             cap)

    # ----------------------------------------------------------------- write
    def adopt_store(self, ids: Sequence[Any], *,
                    refresh: bool = True) -> None:
        """Register rows that ALREADY exist in the host plane (a plane
        filled out of process).  ``ids[i]`` names plane row i; must cover
        the whole plane, may only be called on a fresh index.  With
        ``refresh`` the PQ snapshot is built immediately; rows are
        pre-normalized by contract, matching ``add``'s post-normalize
        state."""
        n = len(self.store)
        if self.n_rows != 0:
            raise ValueError("adopt_store requires a fresh index")
        if len(ids) != n:
            raise ValueError(f"adopt_store: {len(ids)} ids for a plane of "
                             f"{n} rows")
        self._ids = list(ids)
        for r, i in enumerate(self._ids):
            self._id_rows.setdefault(i, []).append(r)
        if refresh:
            self.refresh_snapshot()
        elif n:
            # no snapshot yet: serve the whole plane via the exact tail
            self.tail.add(self.store.get(np.arange(n)), self._ids)

    def add(self, embeddings, ids: Sequence[Any]) -> list[int]:
        embeddings = _host(embeddings)
        n = embeddings.shape[0]
        if embeddings.shape != (n, self.dim) or len(ids) != n:
            raise ValueError(f"add: embeddings {embeddings.shape} with "
                             f"{len(ids)} ids, index dim {self.dim}")
        if n == 0:
            return []
        if self.normalize:
            embeddings = embeddings / np.maximum(
                np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
        offset = self.n_rows
        self.store.add(embeddings)            # host plane (source of truth)
        self.tail.add(embeddings, ids)        # device exact tier
        rows = list(range(offset, offset + n))
        self._ids.extend(ids)
        for r, i in zip(rows, ids):
            self._id_rows.setdefault(i, []).append(r)
        self._maybe_refresh()
        return rows

    def delete(self, ids: Sequence[Any]) -> int:
        rows: list[int] = []
        for i in ids:
            rows.extend(self._id_rows.pop(i, []))
        if not rows:
            return 0
        snap_rows = [r for r in rows if r < self._n_snap]
        if snap_rows:
            idx = torch.as_tensor(snap_rows, dtype=torch.long,
                                  device=self.device)
            with self._lock:
                snap_bias = self._snap_bias.clone()  # readers keep the old
                snap_bias[idx] = NEG_INF
                self._snap_bias = snap_bias
        # the tail holds the same chunk ids for its rows; its delete is a
        # no-op for snapshot-only ids
        self.tail.delete(list(ids))
        for r in rows:
            self._ids[r] = None
        self._n_dead += len(rows)
        return len(rows)

    # --------------------------------------------------------------- refresh
    def _needs_refresh(self) -> bool:
        n_tail = self.n_rows - self._n_snap
        if self.n_rows < self.min_snapshot_rows:
            return False
        if self._n_snap == 0:
            return True
        return n_tail >= self.refresh_fraction * max(self._n_snap, 1)

    def _refresh_guarded(self) -> None:
        # a refresh failure must not propagate out of add(): the rows ARE
        # appended (host plane + exact tail) and serving stays correct on
        # the stale snapshot
        try:
            self.refresh_snapshot()
        except Exception:
            self.refresh_failures += 1
            logger.exception(
                "xl snapshot refresh failed (%d consecutive); serving "
                "continues on the stale tier", self.refresh_failures)

    def _maybe_refresh(self) -> None:
        if not self._needs_refresh():
            return
        if not self.async_refresh:
            self._refresh_guarded()
            return
        with self._build_lock:
            t = self._refresh_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._refresh_guarded,
                                 name="xl-refresh", daemon=True)
            self._refresh_thread = t
            t.start()

    def refresh_snapshot(self) -> None:
        """Rebuild the IVF-PQ snapshot from the host plane.

        Covers the largest ``build_block_rows`` multiple of the corpus;
        the remainder stays in the exact tail.  The tail is then rebuilt
        to hold only rows past the new snapshot boundary (re-uploaded
        from the host plane with their ids; tombstones reapplied)."""
        with self._build_lock:
            n = self.n_rows
            br = min(self.build_block_rows, max(n, 1))
            n_blocks = n // br
            if n_blocks < 1:
                return
            n_snap_new = n_blocks * br
            store, dev = self.store, self.device

            def plane_block(i):
                return plane_rows(store, i * br, (i + 1) * br, dev)

            src, covered = self._snapshot_source, self._source_blocks
            if src is not None and br == self.build_block_rows:
                def block_fn(i):
                    # provider contract: bits == plane rows upcast to f32;
                    # blocks past its coverage come from the plane
                    if i < covered:
                        return as_tensor(src(i), dev).to(dev, torch.float32)
                    return plane_block(i)
            else:
                block_fn = plane_block

            nlist = max(1, min(self.nlist, n_snap_new))
            ivf = IVFPQIndex.build_streaming(
                block_fn, n_blocks, br,
                nlist=nlist, block=min(self.block, n_snap_new),
                m=self.pq_m, ksub=self.ksub, refine_m=self.pq_refine_m,
                train_blocks=min(2, n_blocks),
                spill_frac=self.pq_spill, opq_iters=self.pq_opq_iters,
                device=dev)
            ivf.ensure_block_centroids(dtype=torch.bfloat16,
                                       sub=self.block_rank_sub)

            # snapshot tombstone bias from the global id table
            dead = np.fromiter((i is None for i in self._ids[:n_snap_new]),
                               bool, n_snap_new)
            snap_bias = torch.from_numpy(
                np.where(dead, NEG_INF, 0.0).astype(np.float32)).to(dev)

            # rebuild the tail for rows [n_snap_new, n)
            tail = FlatIndex(self.dim, dtype=self.dtype, tile_n=self.tile_n,
                             normalize=False, device=dev)
            if n > n_snap_new:
                rows_np = np.arange(n_snap_new, n)
                emb = self.store.get(rows_np)
                # dead rows get a placeholder id then an immediate
                # tombstone so physical positions stay global-aligned
                ph = [self._ids[r] if self._ids[r] is not None
                      else ("__dead__", int(r)) for r in rows_np]
                tail.add(emb, ph)
                dead_ph = [p for p in ph if isinstance(p, tuple)]
                if dead_ph:
                    tail.delete(dead_ph)

            with self._lock:
                self._ivf = ivf
                self._n_snap = n_snap_new
                self._snap_bias = snap_bias
                self.tail = tail
            self.refresh_failures = 0
            logger.info("xl snapshot refreshed: %d rows (PQ) + %d tail",
                        n_snap_new, n - n_snap_new)

    # ---------------------------------------------------------------- search
    def search_dispatch_parts(self, queries, k: int = 10, *,
                              filter_mask=None, bias=None,
                              nprobe_blocks: int | None = None):
        """Launch the device work of both tiers WITHOUT reading it back.

        → (device_parts, ctx): fetch ``device_parts`` (a flat list of
        tensors) to the host, then pass them to ``search_finalize_parts``
        for the host rerank + tier merge.  ``queries`` must already be
        L2-normalized [B, D] (host array)."""
        queries = np.asarray(queries, np.float32)
        b = queries.shape[0]
        dev = self.device
        with self._lock:
            ivf, n_snap, snap_bias = self._ivf, self._n_snap, self._snap_bias
            tail = self.tail

        # host filter kill-mask and device finite bias by global row
        fm = None if filter_mask is None else _host(filter_mask)
        ub = None if bias is None else \
            torch.as_tensor(bias).to(dev, torch.float32)   # [N] or [B, N]

        parts: list = []
        ctx = {"queries": queries, "k": k, "b": b, "n_snap": n_snap,
               "has_snap": False, "has_tail": False, "rb": None}
        qd = torch.from_numpy(queries).to(dev)
        if ivf is not None and n_snap > 0:
            sb = snap_bias
            if fm is not None:
                # rows past the mask's length are excluded (the FlatIndex
                # convention: a short mask zero-pads)
                fs = np.full((n_snap,), NEG_INF, np.float32)
                m = fm[:n_snap]
                fs[:len(m)][m > 0.0] = 0.0
                sb = sb + torch.from_numpy(fs).to(dev)
            rb = None if ub is None else pad_bias_rows(ub, n_snap)
            if rb is not None:
                # per-query bias: shared parts broadcast over the batch
                sb = sb + rb
            c = max(k, self.rerank_overfetch * k)
            vals_d, rows_d = ivf.search_dispatch(
                qd, k=c, nprobe_blocks=(nprobe_blocks or
                                        self.nprobe_blocks),
                cell_gate=self.cell_gate,
                bias=sb, normalize_queries=False, refine_overfetch=1,
                extract=self.extract, hier_t=self.hier_t)
            parts += [vals_d, rows_d]
            ctx["has_snap"] = True
            ctx["c"] = c
            # finite bias for the host rescore (NEG_INF slots stay dead)
            ctx["rb"] = rb

        n_tail = self.n_rows - n_snap
        if n_tail > 0 and len(tail) > 0:
            cap = tail.capacity
            t_fm = None
            if fm is not None:
                t_fm = np.zeros((cap,), np.float32)
                seg = fm[n_snap:n_snap + cap]
                t_fm[:len(seg)] = seg
            t_b = None if ub is None else \
                pad_bias_rows(ub[..., n_snap:n_snap + cap], cap)
            tv, tr = tail.search_dispatch(qd, k=min(k, max(len(tail), 1)),
                                          filter_mask=t_fm, bias=t_b)
            parts += [tv, tr]
            ctx["has_tail"] = True
        return parts, ctx

    def search_finalize_parts(self, ctx, fetched: list):
        """Host half: exact rerank of the snapshot candidates against the
        host plane, tail offset, tier merge.  ``fetched`` = host values of
        the tensors ``search_dispatch_parts`` returned, in order.
        → (vals [B, k], rows [B, k]) — LOCAL rows of this index."""
        queries, k, b = ctx["queries"], ctx["k"], ctx["b"]
        n_snap = ctx["n_snap"]
        parts_v, parts_r = [], []
        i = 0
        if ctx["has_snap"]:
            vals_h, rows_h = fetched[i], fetched[i + 1]
            i += 2
            rb = None if ctx["rb"] is None else _host(ctx["rb"])
            sv, sr = exact_rerank(self.store, queries, vals_h, rows_h,
                                  k=min(k, ctx["c"]), bias=rb)
            parts_v.append(sv)
            parts_r.append(sr)
        if ctx["has_tail"]:
            tv, tr = fetched[i], fetched[i + 1]
            i += 2
            parts_v.append(np.asarray(tv, np.float32))
            parts_r.append(np.where(np.asarray(tv) > -1e29,
                                    np.asarray(tr, np.int64) + n_snap, -1))

        if not parts_v:
            vals = np.full((b, k), NEG_INF, np.float32)
            rows = np.full((b, k), -1, np.int64)
        else:
            av = np.concatenate(parts_v, axis=1)
            ar = np.concatenate(parts_r, axis=1)
            kk = min(k, av.shape[1])
            order = np.argsort(-av, axis=1)[:, :kk]
            vals = np.take_along_axis(av, order, axis=1)
            rows = np.take_along_axis(ar, order, axis=1)
            if kk < k:
                vals = np.pad(vals, ((0, 0), (0, k - kk)),
                              constant_values=NEG_INF)
                rows = np.pad(rows, ((0, 0), (0, k - kk)),
                              constant_values=-1)
        return vals, rows

    def search(self, queries, k: int = 10, *, filter_mask=None, bias=None,
               nprobe_blocks: int | None = None):
        queries = _host(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.normalize:
            queries = queries / np.maximum(
                np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        parts, ctx = self.search_dispatch_parts(
            queries, k, filter_mask=filter_mask, bias=bias,
            nprobe_blocks=nprobe_blocks)
        vals, rows = self.search_finalize_parts(
            ctx, [p.cpu().numpy() for p in parts])
        ids = [
            [self._ids[int(r)] if (v > -1e29 and 0 <= r < self.n_rows)
             else None
             for r, v in zip(rr, vv)]
            for rr, vv in zip(rows, vals)
        ]
        return ids, vals, rows

    # -------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        """``path`` is the npz prefix (TorchVectorStore passes index.npz).
        The snapshot codes save to ``<path>.ivfpq.npz``; the host plane is
        its own memmap (path recorded, or embedded when RAM-backed)."""
        base = path[:-4] if path.endswith(".npz") else path
        with self._lock:
            ivf, n_snap, snap_bias = self._ivf, self._n_snap, self._snap_bias
        n = self.n_rows
        extra = {}
        if ivf is not None:
            ivf.save(base + ".ivfpq")
            extra["snap_bias"] = snap_bias.cpu().numpy()
        if n > n_snap:
            extra["tail_emb"] = self.store.to_f32(self.store._buf[n_snap:n])
        if self.store.path is None:
            extra["store_rows"] = self.store.to_f32(self.store._buf[:n])
        else:
            self.store.flush()
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            meta=json.dumps({
                "dim": self.dim, "n_snap": n_snap,
                "ids": jsonable_ids(self._ids[:n]),
                "store_path": self.store.path,
                "config": {
                    "nlist": self.nlist, "block": self.block,
                    "pq_m": self.pq_m, "pq_refine_m": self.pq_refine_m,
                    "ksub": self.ksub,
                    "nprobe_blocks": self.nprobe_blocks,
                    "cell_gate": self.cell_gate,
                    "block_rank_sub": self.block_rank_sub,
                    "extract": self.extract,
                    "hier_t": self.hier_t,
                    "rerank_overfetch": self.rerank_overfetch,
                    "pq_spill": self.pq_spill,
                    "pq_opq_iters": self.pq_opq_iters,
                    "min_snapshot_rows": self.min_snapshot_rows,
                    "refresh_fraction": self.refresh_fraction,
                    "build_block_rows": self.build_block_rows,
                }}),
            **extra)

    @classmethod
    def load(cls, path: str, *, device=None, **kw) -> "XlPQIndex":
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        cfg = dict(meta["config"])
        cfg.update(kw)
        store = None
        if meta["store_path"] is None:
            store = HostVectorStore(meta["dim"], dtype=BF16)
            store.add(np.asarray(z["store_rows"], np.float32))
        idx = cls(meta["dim"], store=store, store_path=meta["store_path"],
                  device=device, **cfg)
        ids = meta["ids"]
        if len(idx.store) != len(ids):
            raise ValueError(
                f"host plane at {meta['store_path']} has {len(idx.store)} "
                f"rows; checkpoint expects {len(ids)}")
        idx._ids = list(ids)
        for r, i in enumerate(ids):
            if i is not None:
                idx._id_rows.setdefault(i, []).append(r)
        idx._n_dead = sum(1 for i in ids if i is None)
        idx._n_snap = meta["n_snap"]
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.exists(base + ".ivfpq.npz"):
            idx._ivf = IVFPQIndex.load(base + ".ivfpq", device=idx.device)
            idx._ivf.ensure_block_centroids(dtype=torch.bfloat16,
                                            sub=idx.block_rank_sub)
            idx._snap_bias = torch.from_numpy(
                np.asarray(z["snap_bias"], np.float32)).to(idx.device)
        n_tail = len(ids) - idx._n_snap
        if n_tail > 0:
            emb = np.asarray(z["tail_emb"], np.float32) \
                if "tail_emb" in z else idx.store.get(
                    np.arange(idx._n_snap, len(ids)))
            rows_np = np.arange(idx._n_snap, len(ids))
            ph = [ids[r] if ids[r] is not None else ("__dead__", int(r))
                  for r in rows_np]
            idx.tail.add(emb, ph)
            dead_ph = [p for p in ph if isinstance(p, tuple)]
            if dead_ph:
                idx.tail.delete(dead_ph)
        return idx
