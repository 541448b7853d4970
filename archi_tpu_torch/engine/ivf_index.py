"""IVF (inverted-file) approximate index.

Counterpart of ``archi_tpu/engine/ivf_index.py``: rows are k-means
clustered into ``nlist`` cells (``engine.kmeans``) and a query scans only
its ``nprobe`` nearest cells.

Layout (shared with ``IVFPQIndex``):
- rows are re-ordered cell-contiguously into fixed-size **blocks**
  ``[n_blocks, block, D]``; a cell owns ``ceil(n_c / block)`` blocks;
- ``cell_blocks [nlist, max_bpc]`` maps each cell to its block ids (-1 pad),
  so a query's candidates are a gather of whole blocks.

Queries run in groups: one [G, P*blk] product per group against every
member's probed blocks, with a per-query ownership mask keeping results
exact.  ``nprobe = nlist`` degenerates to exact search.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from archi_tpu_torch.engine.flat_index import (as_dtype, jsonable_ids,
                                               l2_normalize, load_npz)
from archi_tpu_torch.engine.kmeans import kmeans
from archi_tpu_torch.engine.topk import NEG_INF, topk_lower_first
from archi_tpu_torch.utils.hardware import default_device


def cell_block_layout(assign_h: np.ndarray, nlist: int, block: int):
    """Cell-contiguous block layout from host k-means assignments.

    → (gather [n_blocks*block] i64 source row per slot (-1 pad),
       cell_blocks [nlist, max_bpc] i32)."""
    counts = np.bincount(assign_h, minlength=nlist)
    order = np.argsort(assign_h, kind="stable")   # rows cell-contiguous
    bpc = np.maximum(-(-counts // block), 1)      # blocks per cell (>=1)
    n_blocks = int(bpc.sum())
    block_first = np.concatenate([[0], np.cumsum(bpc)])
    src_off = np.concatenate([[0], np.cumsum(counts)])
    gather = np.full((n_blocks * block,), -1, np.int64)
    for c in range(nlist):
        cnt = int(counts[c])
        dst = int(block_first[c]) * block
        gather[dst: dst + cnt] = order[src_off[c]: src_off[c] + cnt]
    cb = np.full((nlist, int(bpc.max())), -1, np.int32)
    for c in range(nlist):
        cb[c, : bpc[c]] = np.arange(block_first[c], block_first[c + 1])
    return gather, cb


def bias_to_block_layout(bias, block_rows, block_rows_valid):
    """[N] (or per-query [B, N]) original-row bias → [n_blocks, blk]
    (resp. [B, n_blocks, blk]) block-layout bias; pad slots get 0 (they
    are masked by ``block_rows_valid``)."""
    safe = torch.clamp(block_rows, 0, bias.shape[-1] - 1).long()
    if bias.dim() == 2:
        return bias[:, safe] * block_rows_valid[None]
    return bias[safe] * block_rows_valid


def owner_mask(g_sz: int, p: int, per_q: int, device) -> torch.Tensor:
    """[G, p] True where block slot p was probed by query p // per_q."""
    owner = torch.arange(p, device=device) // per_q
    return owner[None, :] == torch.arange(g_sz, device=device)[:, None]


def pad_queries(queries, bias, group: int):
    """Pad a query batch (and a per-query [B, N] bias) with zero rows to a
    multiple of ``group``."""
    pad = (-queries.shape[0]) % group
    if pad:
        queries = torch.cat([queries, queries.new_zeros(
            (pad, queries.shape[1]))])
        if bias is not None and bias.dim() == 2:
            bias = torch.cat([bias, bias.new_zeros((pad, bias.shape[1]))])
    return queries, bias


def slots_to_rows(vals, gpos, block_rows_flat):
    """Flat slot positions → original rows (-1 where the slot lost)."""
    return torch.where(vals > -1e29, block_rows_flat[gpos.long()],
                       torch.full_like(gpos, -1)).to(torch.int32)


def _ivf_search(queries, centroids, blocks, block_rows_valid, cell_blocks,
                bias_by_slot, *, k, nprobe, group):
    """queries [B, D] (B % group == 0); blocks [n_blocks, blk, D];
    bias_by_slot [n_blocks, blk] or [B, n_blocks, blk] or None.
    → (vals [B, k], flat slot positions [B, k] = block_id*blk + slot)."""
    blk, d = blocks.shape[1], blocks.shape[2]
    per_q = nprobe * cell_blocks.shape[1]  # block slots owned by each query
    out_v, out_p = [], []
    for g0 in range(0, queries.shape[0], group):
        qg = queries[g0:g0 + group]
        g_sz = qg.shape[0]
        _cv, cells = topk_lower_first(qg @ centroids.T, nprobe)
        bids = cell_blocks[cells].reshape(-1)                 # [G*per_q]
        valid_block = bids >= 0
        safe = torch.where(valid_block, bids, 0).long()
        cand = blocks[safe].reshape(-1, d)                     # [P*blk, D]
        scores = qg @ cand.float().T                           # [G, P*blk]
        if bias_by_slot is not None and bias_by_slot.dim() == 3:
            scores = scores + bias_by_slot[g0:g0 + g_sz][:, safe, :].reshape(
                g_sz, -1)
        elif bias_by_slot is not None:
            scores = scores + bias_by_slot[safe].reshape(-1)[None, :]
        p = safe.shape[0]
        slot_ok = owner_mask(g_sz, p, per_q, qg.device) & valid_block[None, :]
        row_ok = block_rows_valid[safe].reshape(-1) > 0.5
        mask = torch.repeat_interleave(slot_ok, blk, dim=1) & row_ok[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        vals, pos = topk_lower_first(scores, k)
        out_v.append(vals)
        out_p.append(safe[pos // blk] * blk + pos % blk)
    return torch.cat(out_v), torch.cat(out_p).to(torch.int32)


class IVFIndex:
    """Built from a snapshot of (normalized) embeddings + ids."""

    def __init__(self, centroids, blocks, block_rows, cell_blocks, ids,
                 *, dtype=torch.bfloat16, device=None):
        self.device = default_device(device)
        dev = self.device
        self.centroids = torch.as_tensor(centroids).to(dev, torch.float32)
        self.blocks = torch.as_tensor(blocks).to(dev, as_dtype(dtype))
        # [n_blocks, blk] -> original row (-1 pad)
        self.block_rows = np.asarray(block_rows)
        self._block_rows_dev = torch.as_tensor(
            self.block_rows.astype(np.int32), device=dev)
        self.block_rows_valid = (self._block_rows_dev >= 0).float()
        self.cell_blocks = torch.as_tensor(
            np.asarray(cell_blocks, np.int32), device=dev).long()
        # ids=None → identity mapping (row IS the id)
        self._ids = list(ids) if ids is not None else None
        self._n_rows = int((self.block_rows >= 0).sum()) if ids is None \
            else len(self._ids)
        self.nlist = self.centroids.shape[0]
        self.block = self.blocks.shape[1]
        self.dim = self.blocks.shape[2]

    def _id_of(self, row: int):
        return self._ids[row] if self._ids is not None else row

    def __len__(self) -> int:
        return self._n_rows

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, embeddings, ids, *, nlist: int = 1024, block: int = 512,
              iters: int = 10, seed: int = 0, dtype=torch.bfloat16,
              device=None):
        """Host-array build: normalize, k-means, cell-contiguous blocks."""
        x = np.asarray(embeddings, np.float32)
        n = x.shape[0]
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        dev = default_device(device)
        nlist = max(1, min(nlist, n))
        centroids, assign = kmeans(torch.as_tensor(x, device=dev), nlist,
                                   iters=iters, seed=seed)
        gather, cb = cell_block_layout(assign.cpu().numpy(), nlist, block)
        blocks = np.where(gather[:, None] >= 0, x[np.clip(gather, 0, None)],
                          0.0).reshape(-1, block, x.shape[1])
        return cls(centroids, blocks, gather.reshape(-1, block), cb, ids,
                   dtype=dtype, device=dev)

    @classmethod
    def build_device(cls, x, ids=None, *, nlist: int = 1024,
                     block: int = 512, iters: int = 10, seed: int = 0,
                     dtype=torch.bfloat16):
        """Build from a device-resident normalized corpus ``x [N, D]``:
        k-means on the device, the block layout on the host from the
        assignments, the reorder one device gather."""
        n, d = x.shape
        nlist = max(1, min(nlist, n))
        centroids, assign = kmeans(x, nlist, iters=iters, seed=seed)
        gather, cb = cell_block_layout(assign.cpu().numpy(), nlist, block)
        safe = torch.as_tensor(np.where(gather >= 0, gather, 0),
                               device=x.device)
        blocks = x[safe].reshape(-1, block, d).to(as_dtype(dtype))
        return cls(centroids, blocks, gather.reshape(-1, block), cb, ids,
                   dtype=dtype, device=x.device)

    # ----------------------------------------------------------------- search
    def search_dispatch(self, queries, k: int = 10, *, nprobe: int = 64,
                        bias=None, normalize_queries: bool = True,
                        vmem_budget_rows: int = 1 << 17):
        """Device-only: → (vals [B, k] f32, original_rows [B, k] i32 with
        -1 for dead slots)."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        b = q.shape[0]
        nprobe = min(nprobe, self.nlist)
        max_bpc = int(self.cell_blocks.shape[1])
        # small groups: each member re-scores the whole group's blocks
        rows_per_q = max(nprobe * max_bpc * self.block, 1)
        group = max(1, min(4, vmem_budget_rows // rows_per_q, b))
        bb = None if bias is None else \
            torch.as_tensor(bias).to(self.device, torch.float32)
        q, bb = pad_queries(q, bb, group)
        if normalize_queries:
            q = l2_normalize(q)
        bias_by_slot = None if bb is None else bias_to_block_layout(
            bb, self._block_rows_dev, self.block_rows_valid)
        vals, gpos = _ivf_search(
            q, self.centroids, self.blocks, self.block_rows_valid,
            self.cell_blocks, bias_by_slot, k=k, nprobe=nprobe, group=group)
        vals, gpos = vals[:b], gpos[:b]
        return vals, slots_to_rows(vals, gpos, self._block_rows_dev.reshape(-1))

    def search(self, queries, k: int = 10, *, nprobe: int = 64,
               bias=None, normalize_queries: bool = True,
               vmem_budget_rows: int = 1 << 17):
        """bias: optional f32 vector by ORIGINAL row — tombstones/filters as
        NEG_INF, hybrid BM25 as finite values (the flat kernel's contract)."""
        vals, rows = self.search_dispatch(
            queries, k, nprobe=nprobe, bias=bias,
            normalize_queries=normalize_queries,
            vmem_budget_rows=vmem_budget_rows)
        vals = vals.cpu().numpy()
        rows_out = rows.cpu().numpy()
        ids_out = [
            [self._id_of(int(r)) if int(r) >= 0 else None for r in rr]
            for rr in rows_out
        ]
        return ids_out, vals, rows_out

    # -------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            centroids=self.centroids.cpu().numpy(),
            blocks=self.blocks.float().cpu().numpy(),
            block_rows=self.block_rows,
            cell_blocks=self.cell_blocks.to(torch.int32).cpu().numpy(),
            meta=json.dumps({"ids": None if self._ids is None
                             else jsonable_ids(self._ids)}),
        )

    @classmethod
    def load(cls, path: str, *, dtype=torch.bfloat16,
             device=None) -> "IVFIndex":
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        return cls(z["centroids"], z["blocks"], z["block_rows"],
                   z["cell_blocks"], meta["ids"], dtype=dtype, device=device)
