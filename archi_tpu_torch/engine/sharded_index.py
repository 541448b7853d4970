"""Corpus-sharded flat index over a list of devices.

Counterpart of ``archi_tpu/engine/sharded_index.py``.  The chunk axis of
the embedding matrix is cut into ``n_shards`` equal, tile-aligned shards,
each its own ``[shard_cap, D]`` tensor (and ``[shard_cap]`` liveness) on
its device; a query runs the fused top-k kernel on every shard, and the
per-shard (k scores, k global rows) — bytes, not MBs — are copied to the
first device and merged.  With a ``torch.distributed`` group initialized
the index is one program over the group's processes (every rank makes the
same calls with the same arguments, as the JAX package's multi-host mesh
does): a rank holds the shards ``[rank · n_local, (rank + 1) · n_local)``,
and its merged top-k goes through ``all_gather`` and a final merge, so
every rank returns the same answer.

Correctness at shard seams:

- global row = local row + shard · shard_cap;
- per-shard ``n_active`` is clamped, so a partly filled shard masks its
  padding and an empty one contributes only NEG_INF entries, which lose
  the merge;
- equal scores rank by the lower global row, as ``lax.top_k`` over the
  shard-major concatenation does: the merge keeps the lower position
  (``topk_lower_first``), and positions are shard-major.

Growth doubles the capacity, so ``shard_cap`` doubles and rows change
shard.  New shard t takes the old shards ``t·f .. t·f + f - 1`` (f the
growth factor) as device copies (between ranks: ``send``/``recv``); the
new tensors, ``shard_cap`` and capacity are swapped in together under
``_buf_lock``, so a concurrent search reads the old layout or the new one.
Global row numbers never change.

``save`` writes ``FlatIndex``'s npz layout in global row order, which
``FlatIndex.load`` of either package reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from archi_tpu_torch.engine.distributed import (all_gather, comm_device,
                                                data_mesh, process_group)
from archi_tpu_torch.engine.flat_index import (MIN_CAPACITY, FlatIndex,
                                               _bucket, l2_normalize)
from archi_tpu_torch.engine.topk import (alive_to_bias, pad_bias_rows,
                                         topk_lower_first, topk_scores)
from archi_tpu_torch.ops.topk import quantize_int8


def _merge(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """[B, W] candidates in shard-major order → the top-k, equal scores by
    the lower position (so the lower global row)."""
    v, pos = topk_lower_first(vals, k)
    return v, torch.gather(rows, 1, pos)


def sharded_search(queries, shards, biases, n_rows: int, *, k: int,
                   first_shard: int = 0, group=None):
    """Top-k of ``q · E[i] + bias[i]`` over a corpus cut into shards.

    Args:
      queries: [B, D] f32.
      shards: this process's shard corpora, each [shard_cap, D] on its
        device; shard j is global shard ``first_shard + j``.
      biases: per shard, [shard_cap] or [B, shard_cap] f32 on its device.
      n_rows: global count of rows in use (rows past it are padding).
      group: a ``torch.distributed`` group whose ranks hold the other
        shards (in rank order); None: these shards are the whole corpus.
    Returns:
      (vals [B, k] f32, global rows [B, k] int64) on the first shard's
      device, the same on every rank of ``group``.
    """
    dev0 = shards[0].device
    shard_cap = shards[0].shape[0]
    parts_v, parts_r = [], []
    # every shard's scan is launched before any result is read
    for j, (emb, bias) in enumerate(zip(shards, biases)):
        lo = (first_shard + j) * shard_cap
        active = max(0, min(int(n_rows) - lo, shard_cap))
        v, r = topk_scores(queries.to(emb.device), emb, bias, active, k=k)
        parts_v.append(v.to(dev0))
        parts_r.append(r.to(dev0, torch.int64) + lo)
    vals, rows = _merge(torch.cat(parts_v, 1), torch.cat(parts_r, 1), k)
    if group is not None:
        vals, rows = _merge(torch.cat(all_gather(vals, group), 1),
                            torch.cat(all_gather(rows, group), 1), k)
    return vals, rows


class ShardedFlatIndex(FlatIndex):
    """FlatIndex whose corpus rows are sharded across devices."""

    #: a per-query [B, N] bias is cut on the row axis like a shared one
    supports_batched_bias = True

    def __init__(self, dim: int, *, devices=None, device=None, **kw):
        """``devices``: this process's shard devices (default: every
        visible CUDA device; a device may repeat).  ``device`` alone places
        one shard there.  ``kw``: FlatIndex's dtype, tile_n, normalize,
        metric."""
        if devices is None and device is not None:
            devices = [device]
        self.devices = data_mesh(devices)
        _group, world, rank = process_group()
        self.n_local = len(self.devices)
        self.n_shards = world * self.n_local
        self.first_shard = rank * self.n_local
        super().__init__(dim, device=self.devices[0], **kw)

    @property
    def group(self):
        """The process group the shards span (None: all are here), checked
        against the layout the index was made with: a group initialized
        later must have the same world size and rank."""
        group, world, rank = process_group()
        if (world * self.n_local, rank * self.n_local) != \
                (self.n_shards, self.first_shard):
            raise RuntimeError(
                f"process group of {world} (rank {rank}) does not match the "
                f"index's {self.n_shards} shards from {self.first_shard}")
        return group

    # ---------------------------------------------------------------- layout
    def _min_capacity(self) -> int:
        return max(MIN_CAPACITY, self.n_shards * self.tile_n)

    def _sharded_capacity(self, n: int) -> int:
        """The smallest doubling of n_shards · tile_n holding ``n`` rows
        (and the minimum capacity): every shard stays tile-aligned."""
        cap = self.n_shards * self.tile_n
        while cap < max(self._min_capacity(), n):
            cap *= 2
        return cap

    def _zeros(self, shard_cap: int):
        embs = [torch.zeros((shard_cap, self.dim), dtype=self.dtype, device=d)
                for d in self.devices]
        alives = [torch.zeros((shard_cap,), dtype=torch.float32, device=d)
                  for d in self.devices]
        return embs, alives

    def _reset_buffers(self) -> None:
        cap = self._sharded_capacity(0)
        embs, alives = self._zeros(cap // self.n_shards)
        with self._buf_lock:
            self._embs, self._alives = embs, alives
            self.capacity, self.shard_cap = cap, cap // self.n_shards
        self.n_rows = 0
        self._ids: list = []
        self._id_rows: dict = {}
        self._n_dead = 0

    def _global(self, parts) -> torch.Tensor:
        """Shard tensors → the whole [capacity, ...] tensor on the first
        device, in global row order."""
        local = torch.cat([p.to(self.device) for p in parts])
        group = self.group
        return local if group is None else torch.cat(all_gather(local, group))

    @property
    def emb(self) -> torch.Tensor:
        """[capacity, D] stored rows (a copy, gathered from the shards)."""
        with self._buf_lock:
            embs = self._embs
        return self._global(embs)

    @property
    def alive(self) -> torch.Tensor:
        """[capacity] f32 liveness by global row (a copy)."""
        with self._buf_lock:
            alives = self._alives
        return self._global(alives)

    # ----------------------------------------------------------------- write
    def _grow_to(self, n: int) -> None:
        """Grow to a capacity holding ``n`` rows: every row moves to the
        shard that covers it at the new ``shard_cap`` (device copies; across
        ranks send/recv), and the new shards are swapped in together with
        the capacity."""
        cap = self._sharded_capacity(n)
        if cap <= self.capacity:
            return
        with self._buf_lock:
            old_embs, old_alives = self._embs, self._alives
            old_sc, n_rows = self.shard_cap, self.n_rows
        sc = cap // self.n_shards
        f = sc // old_sc
        embs, alives = self._zeros(sc)
        # only the old shards that hold rows in use have anything to move
        used = min(self.n_shards, -(-n_rows // old_sc))
        for s in range(used):
            t = s // f                       # the new shard that covers s
            live = min(n_rows - s * old_sc, old_sc)
            at = (s - t * f) * old_sc
            src, dst = s - self.first_shard, t - self.first_shard
            mine_src = 0 <= src < self.n_local
            mine_dst = 0 <= dst < self.n_local
            if mine_src and mine_dst:
                embs[dst][at:at + live] = old_embs[src][:live]
                alives[dst][at:at + live] = old_alives[src][:live]
            elif mine_src or mine_dst:
                self._move(old_embs[src][:live] if mine_src else None,
                           old_alives[src][:live] if mine_src else None,
                           embs[dst][at:at + live] if mine_dst else None,
                           alives[dst][at:at + live] if mine_dst else None,
                           s, t, live)
        with self._buf_lock:
            self._embs, self._alives = embs, alives
            self.capacity, self.shard_cap = cap, sc

    def _move(self, emb_src, alive_src, emb_dst, alive_dst, s, t, live):
        """Shard s's rows in use travel to the rank that holds new shard t."""
        dev = comm_device(self.group)
        peer = (t if emb_src is not None else s) // self.n_local
        if emb_src is not None:
            dist.send(emb_src.contiguous().view(torch.uint8).to(dev), peer,
                      group=self.group)
            dist.send(alive_src.to(dev), peer, group=self.group)
            return
        buf = torch.empty((live, self.dim * emb_dst.element_size()),
                          dtype=torch.uint8, device=dev)
        dist.recv(buf, peer, group=self.group)
        emb_dst.copy_(buf.view(self.dtype).to(emb_dst.device))
        abuf = torch.empty((live,), dtype=torch.float32, device=dev)
        dist.recv(abuf, peer, group=self.group)
        alive_dst.copy_(abuf.to(alive_dst.device))

    def _write_block(self, block: torch.Tensor, alive_block: torch.Tensor,
                     offset: int, n_rows: int) -> None:
        """Write stored rows (in the index's dtype) and their liveness at
        global ``offset`` into NEW copies of the shards they touch (a block
        may cross seams) and swap them in with ``n_rows`` under
        ``_buf_lock``: a concurrent search sees the old (shards, n_rows) or
        the new, never a mix.  The block must fit the current capacity."""
        end = offset + block.shape[0]
        if end > self.capacity:
            raise ValueError(f"block rows [{offset}, {end}) exceed the "
                             f"capacity {self.capacity}")
        with self._buf_lock:
            embs, alives = list(self._embs), list(self._alives)
        sc = self.shard_cap
        for j, dev in enumerate(self.devices):
            lo = (self.first_shard + j) * sc
            a, b = max(offset, lo), min(end, lo + sc)
            if a >= b:
                continue
            embs[j] = embs[j].clone()
            alives[j] = alives[j].clone()
            embs[j][a - lo:b - lo] = block[a - offset:b - offset].to(
                dev, self.dtype)
            alives[j][a - lo:b - lo] = alive_block[a - offset:b - offset].to(
                dev, torch.float32)
        with self._buf_lock:
            self._embs, self._alives, self.n_rows = embs, alives, n_rows

    def add(self, embeddings, ids) -> list[int]:
        """Append embeddings ([n, D] numpy or tensor); returns their global
        rows."""
        x = torch.as_tensor(embeddings).to(self.device, torch.float32)
        n = x.shape[0]
        if x.shape != (n, self.dim) or len(ids) != n:
            raise ValueError(f"add: embeddings {tuple(x.shape)} with "
                             f"{len(ids)} ids, index dim {self.dim}")
        if n == 0:
            return []
        if self.normalize:
            x = l2_normalize(x)
        x = quantize_int8(x) if self.dtype == torch.int8 else x.to(self.dtype)
        offset = self.n_rows
        self._grow_to(offset + n)
        # room for the whole write bucket, as in the JAX package
        if offset + _bucket(n) > self.capacity:
            self._grow_to(offset + _bucket(n))
        self._write_block(x, torch.ones((n,), device=self.device), offset,
                          offset + n)
        rows = list(range(offset, offset + n))
        self._ids.extend(ids)
        for r, i in zip(rows, ids):
            self._id_rows.setdefault(i, []).append(r)
        return rows

    def delete(self, ids) -> int:
        """Tombstone all rows of the given chunk ids (in their shards)."""
        rows: list[int] = []
        for i in ids:
            rows.extend(self._id_rows.pop(i, []))
        if not rows:
            return 0
        rows_np = np.asarray(rows, np.int64)
        with self._buf_lock:
            alives = list(self._alives)
        sc = self.shard_cap
        for j, dev in enumerate(self.devices):
            lo = (self.first_shard + j) * sc
            mine = rows_np[(rows_np >= lo) & (rows_np < lo + sc)] - lo
            if mine.size:
                alives[j] = alives[j].clone()  # readers keep the old mask
                alives[j][torch.as_tensor(mine, device=dev)] = 0.0
        with self._buf_lock:
            self._alives = alives
        for r in rows:
            self._ids[r] = None
        self._n_dead += len(rows)
        return len(rows)

    # ---------------------------------------------------------------- search
    def search_dispatch(self, queries, k: int = 10, *, filter_mask=None,
                        bias=None):
        """Run every shard's scan and the merge → DEVICE (vals [B, k],
        global rows [B, k] int64) on the first device."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        if self.normalize:
            q = l2_normalize(q)
        with self._buf_lock:  # consistent snapshot vs concurrent ingest
            embs, alives = self._embs, self._alives
            cap, sc, n_rows = self.capacity, self.shard_cap, self.n_rows
        fm = None if filter_mask is None else pad_bias_rows(
            torch.as_tensor(filter_mask).to(self.device, torch.float32), cap)
        ub = None if bias is None else pad_bias_rows(
            torch.as_tensor(bias).to(self.device, torch.float32), cap)
        biases = []
        for j, (dev, alive) in enumerate(zip(self.devices, alives)):
            lo = (self.first_shard + j) * sc
            if fm is not None:
                alive = alive * fm[lo:lo + sc].to(dev)
            row_bias = alive_to_bias(alive)
            if ub is not None:
                row_bias = row_bias + ub[..., lo:lo + sc].to(dev)
            biases.append(row_bias)
        k_eff = min(k, max(len(self), 1))
        return sharded_search(q, embs, biases, n_rows, k=k_eff,
                              first_shard=self.first_shard, group=self.group)
