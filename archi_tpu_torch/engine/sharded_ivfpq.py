"""Sharded IVF-PQ: PQ-compressed shards, one ``IVFPQIndex`` a device.

Counterpart of ``archi_tpu/engine/sharded_ivfpq.py``: the fan-out and merge
of ``ShardedIVFIndex`` (rows partitioned contiguously across devices,
per-shard search, a bytes-sized host merge) with an ``IVFPQIndex`` on each
device, so a device's capacity is set by the code size, not the vector
size.  Each shard's probe runs the 8-bit ADC kernel.

The global additive-bias contract (tombstones / filters / hybrid BM25 by
global row) holds: each shard receives the slice of the bias covering its
contiguous row range.  Every shard's search is launched before any result
is read, and the results come to the host in one wait per device.
"""

from __future__ import annotations

import numpy as np
import torch

from archi_tpu_torch.engine.distributed import data_mesh, fetch
from archi_tpu_torch.engine.host_store import exact_rerank
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
from archi_tpu_torch.engine.xl_index import _host


class ShardedIVFPQIndex:
    def __init__(self, shards: list[IVFPQIndex], offsets: list[int], ids):
        self.shards = shards
        self.offsets = offsets  # global row offset per shard
        self._ids = list(ids) if ids is not None else None
        self._n = sum(len(s) for s in shards)

    def __len__(self) -> int:
        return self._n

    @classmethod
    def build(cls, embeddings, ids=None, *, devices=None, nlist: int = 1024,
              block: int = 512, m: int = 48, refine_m: int = 48,
              seed: int = 0, **kw):
        """Partition rows contiguously across ``devices`` (default: every
        visible CUDA device; a device may repeat); one IVF-PQ each, seeded
        ``seed + s``.  ``kw``: ``IVFPQIndex.build_device``'s options."""
        devices = data_mesh(devices)
        x = _host(embeddings)
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        n = x.shape[0]
        shard_size = int(np.ceil(n / len(devices)))
        shards, offsets = [], []
        for s, dev in enumerate(devices):
            lo, hi = s * shard_size, min((s + 1) * shard_size, n)
            if lo >= hi:
                continue
            shards.append(IVFPQIndex.build(
                x[lo:hi], None, device=dev,
                nlist=max(1, min(nlist, hi - lo)), block=block,
                m=m, refine_m=refine_m, seed=seed + s, **kw))
            offsets.append(lo)
        return cls(shards, offsets, ids)

    def search(self, queries, k: int = 10, *, nprobe: int = 64,
               nprobe_blocks: int | None = None,
               cell_gate: int | None = None, bias=None,
               refine_overfetch: int | None = None, rerank_store=None,
               rerank_overfetch: int = 4):
        """Fan out (every shard launched before any is read), merge the
        per-shard (vals, global rows) on the host.  bias: f32 by GLOBAL
        row; each shard gets its contiguous slice.  rerank_store: optional
        global-row-aligned ``HostVectorStore`` for the exact final tier."""
        queries = _host(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if bias is not None:
            bias = _host(bias)
        if refine_overfetch is None:
            # same resolution as IVFPQIndex.search: with a host rerank the
            # refine rescore is a pure reorder of the candidate set
            refine_overfetch = 1 if rerank_store is not None else 8
        k1 = k if rerank_store is None else max(k, rerank_overfetch * k)

        dispatched = []
        for shard, lo in zip(self.shards, self.offsets):
            sb = None if bias is None else \
                torch.from_numpy(np.ascontiguousarray(
                    bias[..., lo: lo + len(shard)])).to(shard.device)
            dispatched.append((lo, shard.search_dispatch(
                torch.from_numpy(queries).to(shard.device), k=k1,
                nprobe=nprobe, nprobe_blocks=nprobe_blocks,
                cell_gate=cell_gate, bias=sb,
                refine_overfetch=refine_overfetch)))
        # one fetch across all shards
        fetched = fetch([t for _lo, vr in dispatched for t in vr])
        all_vals = np.concatenate(fetched[0::2], axis=1)
        all_rows = np.concatenate([
            np.where(r >= 0, r.astype(np.int64) + lo, -1)
            for r, (lo, _d) in zip(fetched[1::2], dispatched)
        ], axis=1)                                            # [B, S*k]
        if rerank_store is not None:
            qn = queries / np.maximum(
                np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
            vals, rows = exact_rerank(rerank_store, qn, all_vals, all_rows,
                                      k=k, bias=bias)
        else:
            order = np.argsort(-all_vals, axis=1)[:, :k]
            vals = np.take_along_axis(all_vals, order, axis=1)
            rows = np.take_along_axis(all_rows, order, axis=1)
        ids_out = [
            [(self._ids[int(r)] if self._ids is not None else int(r))
             if (v > -1e29 and r >= 0) else None
             for r, v in zip(rr, vv)]
            for rr, vv in zip(rows, vals)
        ]
        return ids_out, vals, rows
