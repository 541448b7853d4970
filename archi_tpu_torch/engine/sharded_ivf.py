"""Sharded IVF: approximate search over corpora larger than one device.

Counterpart of ``archi_tpu/engine/sharded_ivf.py``.  The corpus rows are
partitioned contiguously across the devices; each device holds an
independent ``IVFIndex`` (its own centroids and cell-blocked rows).  A query
fans out to every shard, then the per-shard (k scores, k global rows) merge
on the host — the bytes-sized merge of ``ShardedFlatIndex`` without one
program across shards.  Row ids are global; shard s owns rows
``[s · shard_size, (s + 1) · shard_size)``.

Every build and search names its shard's device (``device=``): the port's
indexes read no ambient default device.
"""

from __future__ import annotations

import numpy as np
import torch

from archi_tpu_torch.engine.distributed import data_mesh
from archi_tpu_torch.engine.ivf_index import IVFIndex
from archi_tpu_torch.engine.xl_index import _host


class ShardedIVFIndex:
    def __init__(self, shards: list[IVFIndex], offsets: list[int], ids):
        self.shards = shards
        self.offsets = offsets  # global row offset per shard
        self._ids = list(ids)

    def __len__(self) -> int:
        return len(self._ids)

    @classmethod
    def build(cls, embeddings, ids, *, devices=None, nlist: int = 1024,
              block: int = 512, iters: int = 10, seed: int = 0,
              dtype=torch.bfloat16):
        """Partition rows contiguously across ``devices`` (default: every
        visible CUDA device; a device may repeat) and build one IVF on
        each, seeded ``seed + s``."""
        devices = data_mesh(devices)
        x = _host(embeddings)
        n = x.shape[0]
        shard_size = int(np.ceil(n / len(devices)))
        shards, offsets = [], []
        for s, dev in enumerate(devices):
            lo, hi = s * shard_size, min((s + 1) * shard_size, n)
            if lo >= hi:
                continue
            sub_ids = list(range(lo, hi))  # local->global row mapping
            shards.append(IVFIndex.build(
                x[lo:hi], sub_ids, nlist=max(1, min(nlist, hi - lo)),
                block=block, iters=iters, seed=seed + s, dtype=dtype,
                device=dev))
            offsets.append(lo)
        return cls(shards, offsets, ids)

    def search(self, queries, k: int = 10, *, nprobe: int = 64):
        """Fan out to all shards, merge the per-shard top-k on the host."""
        queries = _host(queries)
        if queries.ndim == 1:
            queries = queries[None, :]

        per_shard = [s.search(queries, k=k, nprobe=nprobe)
                     for s in self.shards]
        all_vals = np.concatenate([vals for _i, vals, _r in per_shard],
                                  axis=1)                      # [B, S*k]
        # each shard's ids ARE global rows (built with local->global maps)
        all_rows = np.concatenate([
            np.array([[g if g is not None else -1 for g in row]
                      for row in ids], dtype=np.int64)
            for ids, _v, _r in per_shard
        ], axis=1)
        order = np.argsort(-all_vals, axis=1)[:, :k]
        vals = np.take_along_axis(all_vals, order, axis=1)
        rows = np.take_along_axis(all_rows, order, axis=1)
        ids_out = [
            [self._ids[int(r)] if (v > -1e29 and 0 <= int(r) < len(self._ids))
             else None
             for r, v in zip(rr, vv)]
            for rr, vv in zip(rows, vals)
        ]
        return ids_out, vals, rows
