"""IVF-PQ: coarse inverted-file cells over PQ-coded residuals.

Counterpart of ``archi_tpu/engine/ivfpq_index.py``.  Two levels:

1. **Coarse**: cosine k-means centroids (``engine.kmeans``); a query scans
   the centroids and probes the ``nprobe`` best cells.
2. **Fine**: each row stores ``m`` PQ codes of its RESIDUAL
   ``r = x - centroid[cell]``, one byte each (ksub 256) or two to a byte
   (ksub 16, packed nibbles).  The score is ``q·centroid + ADC(q, r̂)``.

Rows are re-ordered cell-contiguously into ``[n_blocks, blk, mc]`` uint8
code blocks (the ``engine.ivf_index`` layout); queries run in groups whose
members score every member's gathered blocks under an ownership mask; the
per-row additive bias (tombstones / filters as NEG_INF, hybrid BM25 as
finite values) rides the same block layout.  Candidate scoring is the ADC
kernels of ``archi_tpu_torch.ops.adc`` (``adc_impl="kernel"``, the default on
CUDA) or their plain versions (``"plain"``, the default on the CPU).

An optional refinement stage (``refine_m > 0``) re-scores the stage-1
candidates with a second PQ of what stage 1 leaves behind; block-budget
probing (``nprobe_blocks``) ranks single blocks by per-block mini-centroids
instead of whole cells.  ``save``/``load`` use the JAX package's npz
layout, so a snapshot written by either package loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from archi_tpu_torch.engine.flat_index import (as_dtype, jsonable_ids,
                                               l2_normalize, load_npz)
from archi_tpu_torch.engine.host_store import exact_rerank, mark_duplicate_rows
from archi_tpu_torch.engine.ivf_index import (bias_to_block_layout,
                                              cell_block_layout, owner_mask,
                                              pad_queries, slots_to_rows)
from archi_tpu_torch.engine.kmeans import kmeans
from archi_tpu_torch.engine.pq import (PQCodec, _pq_assign, as_tensor,
                                       split_subspaces)
from archi_tpu_torch.engine.topk import NEG_INF, topk_lower_first
from archi_tpu_torch.ops.adc import (adc_scores, adc_scores_lut16,
                                     pack_nibbles, plain_adc_scores,
                                     plain_adc_scores_lut16, unpack_nibbles)

#: ``adc_impl`` values: the CUDA kernels (their plain versions on CPU
#: tensors) or the plain versions on any device
ADC_IMPLS = ("kernel", "plain")
_ADC = {("kernel", False): adc_scores, ("kernel", True): adc_scores_lut16,
        ("plain", False): plain_adc_scores,
        ("plain", True): plain_adc_scores_lut16}


def _luts(qg_r, codebooks):
    """[G, D] (rotated) queries → ADC tables [m, G, ksub] f32."""
    m, _ksub, ds = codebooks.shape
    return torch.einsum("gmd,mkd->mgk", qg_r.reshape(qg_r.shape[0], m, ds),
                        codebooks)


def _extract(scores, kk: int, blk: int, *, approx: bool, hier_t: int):
    """Stage-1 candidate extraction over [G, W] scores → (vals, positions).

    hier_t > 0: top-``hier_t`` within each ``blk``-slot block, then an exact
    merge of the survivors.  approx: the strided layout of the JAX package's
    ApproxTopK path (``approx_max_k`` is exact off a TPU, and so is this)."""
    g_sz, w = scores.shape
    if hier_t > 0 and w % blk == 0 and (w // blk) * min(hier_t, blk) >= kk:
        p, bt = w // blk, min(hier_t, blk)
        v3, p3 = topk_lower_first(scores.reshape(g_sz, p, blk), bt)
        fp = (torch.arange(p, device=scores.device)[None, :, None] * blk
              + p3).reshape(g_sz, -1)
        vals, f = topk_lower_first(v3.reshape(g_sz, -1), kk)
        return vals, torch.gather(fp, 1, f)
    if (approx and kk >= 64 and w % blk == 0 and blk >= 256
            and w >= 16 * kk and w // blk >= 8):
        # formerly adjacent slots (near-duplicate runs of a cell block)
        # land w // blk apart
        r_dim = w // blk
        s2 = scores.reshape(g_sz, r_dim, blk).transpose(1, 2).reshape(g_sz, w)
        vals, f = topk_lower_first(s2, kk)
        return vals, (f % r_dim) * blk + f // r_dim
    return topk_lower_first(scores, kk)


def _score_group(qg_r, cand, cs_slots, slot_ok, row_ok, bias_g, *, codebooks,
                 blk, packed, adc_impl):
    """ADC + coarse score + bias + masks for one query group → [G, P*blk].

    cand [P*blk, mc] u8 gathered blocks; cs_slots [P] owning query's coarse
    score of each block; slot_ok [G, P]; row_ok [P*blk]; bias_g [G, P*blk]
    or [1, P*blk] or None."""
    codes_t = cand.T.contiguous()
    scores = _ADC[adc_impl, packed](_luts(qg_r, codebooks), codes_t)
    # + q·centroid of the block's owner (exact for owned slots; the others
    # are masked below)
    scores = scores + torch.repeat_interleave(cs_slots, blk)[None, :]
    mask = torch.repeat_interleave(slot_ok, blk, dim=1) & row_ok[None, :]
    if bias_g is not None:
        scores = scores + bias_g
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def _group_bias(bias_by_slot, g0, g_sz, bids):
    if bias_by_slot is None:
        return None
    if bias_by_slot.dim() == 3:
        return bias_by_slot[g0:g0 + g_sz][:, bids, :].reshape(g_sz, -1)
    return bias_by_slot[bids].reshape(-1)[None, :]


def _ivfpq_search(queries, centroids, code_blocks, block_rows_valid,
                  cell_blocks, codebooks, rot1, bias_by_slot, *, k, nprobe,
                  group, adc_impl, approx, hier_t, packed):
    """Cell probing.  queries [B, D] (B % group == 0) → (vals [B, k],
    flat slot positions [B, k] = block_id*blk + slot)."""
    blk = code_blocks.shape[1]
    max_bpc = cell_blocks.shape[1]
    per_q = nprobe * max_bpc  # block slots owned by each query
    probe_of_slot = torch.arange(per_q, device=queries.device) // max_bpc
    out_v, out_p = [], []
    for g0 in range(0, queries.shape[0], group):
        qg = queries[g0:g0 + group]
        g_sz = qg.shape[0]
        cv, cells = topk_lower_first(qg @ centroids.T, nprobe)
        bids = cell_blocks[cells].reshape(-1)                 # [G*per_q]
        valid_block = bids >= 0
        safe = torch.where(valid_block, bids, 0)
        p = safe.shape[0]
        scores = _score_group(
            qg if rot1 is None else qg @ rot1,
            code_blocks[safe].reshape(p * blk, -1),
            cv[:, probe_of_slot].reshape(-1),
            owner_mask(g_sz, p, per_q, qg.device) & valid_block[None, :],
            block_rows_valid[safe].reshape(-1) > 0.5,
            _group_bias(bias_by_slot, g0, g_sz, safe),
            codebooks=codebooks, blk=blk, packed=packed, adc_impl=adc_impl)
        vals, pos = _extract(scores, min(k, scores.shape[1]), blk,
                             approx=approx, hier_t=hier_t)
        out_v.append(vals)
        out_p.append(safe[pos // blk] * blk + pos % blk)
    return torch.cat(out_v), torch.cat(out_p).to(torch.int32)


def _ivfpq_search_blocks(queries, centroids, block_centroids, block_cell,
                         code_blocks, block_rows_valid, codebooks, rot1,
                         bias_by_slot, *, k, nprobe_blocks, group, adc_impl,
                         approx, cell_gate, sub, hier_t, packed):
    """Block-budget probing: rank single code blocks by their own
    mini-centroid score (the max over ``sub`` sub-slice means) and ADC
    exactly ``nprobe_blocks`` blocks per query; ``cell_gate`` lets only
    blocks of the query's top-``cell_gate`` cells compete.  Scoring is the
    cell-probing score, so both agree wherever they cover the same blocks."""
    blk = code_blocks.shape[1]
    b = queries.shape[0]
    npb = nprobe_blocks
    cscores_all = queries @ centroids.T                      # [B, nlist]
    bscores = queries.to(block_centroids.dtype).float() @ \
        block_centroids.float().T                            # [B, nb*sub]
    if sub > 1:
        bscores = bscores.reshape(b, -1, sub).amax(dim=2)    # [B, n_blocks]
    if cell_gate is not None and cell_gate < centroids.shape[0]:
        cv, _ = topk_lower_first(cscores_all, cell_gate)
        cs_blk = cscores_all[:, block_cell]                  # [B, n_blocks]
        bscores = torch.where(cs_blk >= cv[:, -1:], bscores,
                              torch.full_like(bscores, NEG_INF))
    _, bids_all = topk_lower_first(bscores, npb)             # [B, npb]
    cs_own = torch.gather(cscores_all, 1, block_cell[bids_all])
    q_rot = queries if rot1 is None else queries @ rot1
    out_v, out_p = [], []
    for g0 in range(0, b, group):
        g_sz = min(group, b - g0)
        bflat = bids_all[g0:g0 + g_sz].reshape(-1)           # [G*npb]
        p = bflat.shape[0]
        scores = _score_group(
            q_rot[g0:g0 + g_sz], code_blocks[bflat].reshape(p * blk, -1),
            cs_own[g0:g0 + g_sz].reshape(-1),
            owner_mask(g_sz, p, npb, queries.device),
            block_rows_valid[bflat].reshape(-1) > 0.5,
            _group_bias(bias_by_slot, g0, g_sz, bflat),
            codebooks=codebooks, blk=blk, packed=packed, adc_impl=adc_impl)
        vals, pos = _extract(scores, min(k, scores.shape[1]), blk,
                             approx=approx, hier_t=hier_t)
        out_v.append(vals)
        out_p.append(bflat[pos // blk] * blk + pos % blk)
    return torch.cat(out_v), torch.cat(out_p).to(torch.int32)


def _refine_rescore(vals, rows, luts2, refine_codes, *, k, packed=False):
    """Re-score stage-1 candidates with the refinement codebook.

    vals/rows [B, C] (ORIGINAL rows, -1 dead); luts2 [B, m2, ksub];
    refine_codes [N, m2] u8 (or [N, m2/2] packed) in original row order.
    The refinement tables are summed in f32 as stored (no bf16 rounding).
    Dead slots (NEG_INF) stay dead.  → (vals [B, k], rows [B, k])."""
    b, c = vals.shape
    safe = torch.clamp(rows.long(), 0, refine_codes.shape[0] - 1)
    rc = refine_codes[safe]                                   # [B, C, mc]
    if packed:
        rc = unpack_nibbles(rc)
    m2 = rc.shape[2]
    picked = luts2[torch.arange(b, device=rc.device)[:, None, None],
                   torch.arange(m2, device=rc.device)[None, None, :],
                   rc.long()]                                 # [B, C, m2]
    scores = torch.where(vals > NEG_INF / 2, vals + picked.sum(dim=-1), vals)
    nv, pos = topk_lower_first(scores, min(k, c))
    return nv, torch.gather(rows, 1, pos)


def _encode_residual(codec, m, rb, pack4):
    """Stage-1 codes of residuals rb [n, D] → ([n, m] u8, stored codes)."""
    codes = _pq_assign(split_subspaces(codec._rotate(rb), m), codec.codebooks)
    c1 = codes.T.to(torch.uint8)
    return c1, (pack_nibbles(c1) if pack4 else c1)


class IVFPQIndex:
    """Built from a device-resident snapshot of normalized embeddings,
    optionally with a refinement stage (``refine_m > 0``) whose codes are
    stored in ORIGINAL row order."""

    def __init__(self, centroids, codec: PQCodec, code_blocks, block_rows,
                 cell_blocks, ids, *, refine_codec: PQCodec | None = None,
                 refine_codes=None, block_centroids=None, device=None):
        self.codec = codec
        self.device = codec.device if device is None else torch.device(device)
        dev = self.device
        self.centroids = as_tensor(centroids, dev).to(dev, torch.float32)
        self.code_blocks = as_tensor(code_blocks, dev).to(dev, torch.uint8)
        self.block_rows = np.asarray(block_rows)   # [n_blocks, blk] (-1 pad)
        self._block_rows_dev = torch.as_tensor(
            self.block_rows.astype(np.int32, copy=False), device=dev)
        self.block_rows_valid = (self._block_rows_dev >= 0).float()
        self.cell_blocks = torch.as_tensor(
            np.asarray(cell_blocks, np.int32), device=dev).long()
        self._ids = list(ids) if ids is not None else None
        # occupied SLOTS (> distinct rows when spill duplicates exist)
        self._n_slots = int((self.block_rows >= 0).sum())
        self._n_rows = self._n_slots if ids is None else len(self._ids)
        self.nlist = self.centroids.shape[0]
        self.block = self.code_blocks.shape[1]
        self.dim = self.centroids.shape[1]
        # packed 4-bit mode: ksub=16 codes stored two per byte
        self.packed = (codec.ksub == 16 and
                       self.code_blocks.shape[2] == codec.m // 2)
        # block-budget probing: per-block mini-centroids (decoded from the
        # codes on first use, see ensure_block_centroids), `sub` of them a
        # block, and the block → owning-cell map
        self.block_centroids = (None if block_centroids is None
                                else as_tensor(block_centroids, dev).to(dev))
        self._bc_sub = (1 if block_centroids is None else
                        max(1, int(self.block_centroids.shape[0]
                                   // self.code_blocks.shape[0])))
        self.block_rank_sub = self._bc_sub
        cb_h = np.asarray(cell_blocks)
        bc_map = np.zeros((self.code_blocks.shape[0],), np.int64)
        valid_cb = cb_h >= 0
        bc_map[cb_h[valid_cb]] = np.nonzero(valid_cb.reshape(-1))[0] \
            // cb_h.shape[1]
        self._block_cell_dev = torch.as_tensor(bc_map, device=dev)
        self.refine_codec = refine_codec
        self.refine_codes = (None if refine_codes is None else
                             as_tensor(refine_codes, dev).to(dev, torch.uint8))

    def _id_of(self, row: int):
        return self._ids[row] if self._ids is not None else row

    def __len__(self) -> int:
        return self._n_rows

    # ------------------------------------------------------------------ build
    @staticmethod
    def _train_codecs(r_sample, m, refine_m, *, ksub, pq_iters, seed, ns,
                      opq_iters=0):
        """Stage-1 codec on coarse residuals (optionally OPQ-rotated);
        optional refinement codec on what stage 1 leaves behind (computed
        in the original space, so it learns its own rotation)."""
        codec = PQCodec.train(r_sample, m, ksub=ksub, iters=pq_iters,
                              seed=seed, sample=ns, opq_iters=opq_iters)
        codec2 = None
        if refine_m:
            r2 = r_sample - codec.decode(codec.encode(r_sample))
            codec2 = PQCodec.train(r2, refine_m, ksub=ksub, iters=pq_iters,
                                   seed=seed + 1, sample=ns,
                                   opq_iters=opq_iters)
        return codec, codec2

    @classmethod
    def build_device(cls, x, ids=None, *, nlist: int = 1024,
                     block: int = 512, m: int = 48, ksub: int = 256,
                     coarse_iters: int = 10, pq_iters: int = 12,
                     seed: int = 0, train_sample: int = 1 << 18,
                     encode_block: int = 1 << 20,
                     refine_m: int = 0, opq_iters: int = 0) -> "IVFPQIndex":
        """Build from a device-resident normalized corpus ``x [N, D]``:
        k-means and PQ training on the device, the block layout on the host
        from the assignments, the reorder one gather of the codes."""
        n = x.shape[0]
        nlist = max(1, min(nlist, n))
        centroids, assign = kmeans(x, nlist, iters=coarse_iters, seed=seed)
        assign = assign.long()
        rng = np.random.default_rng(seed)
        ns = min(n, train_sample)
        rows = torch.as_tensor(np.sort(rng.choice(n, size=ns, replace=False)),
                               device=x.device)
        r_sample = x[rows].float() - centroids[assign[rows]]
        codec, codec2 = cls._train_codecs(
            r_sample, m, refine_m, ksub=ksub, pq_iters=pq_iters, seed=seed,
            ns=ns, opq_iters=opq_iters)
        del r_sample

        pack4 = ksub == 16
        parts, rparts = [], []
        for s in range(0, n, encode_block):
            rb = x[s: s + encode_block].float() - \
                centroids[assign[s: s + encode_block]]
            c1, c1_out = _encode_residual(codec, m, rb, pack4)
            parts.append(c1_out)
            if codec2 is not None:
                r2 = rb - codec.decode(c1)   # decode un-rotates
                rparts.append(_encode_residual(codec2, refine_m, r2, pack4)[1])
        codes = torch.cat(parts)
        refine_codes = torch.cat(rparts) if rparts else None

        gather, cb = cell_block_layout(assign.cpu().numpy(), nlist, block)
        safe = torch.as_tensor(np.where(gather >= 0, gather, 0),
                               device=x.device)
        code_blocks = codes[safe].reshape(-1, block, codes.shape[1])
        return cls(centroids, codec, code_blocks, gather.reshape(-1, block),
                   cb, ids, refine_codec=codec2, refine_codes=refine_codes)

    @classmethod
    def build(cls, embeddings, ids=None, *, device=None,
              **kw) -> "IVFPQIndex":
        """Host-array convenience wrapper (tests / small corpora)."""
        x = np.asarray(embeddings, np.float32)
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return cls.build_device(as_tensor(x, device), ids, **kw)

    @classmethod
    def build_streaming(cls, block_fn, n_blocks: int, block_rows: int,
                        ids=None, *, nlist: int = 2048, block: int = 1024,
                        m: int = 48, ksub: int = 256, coarse_iters: int = 8,
                        pq_iters: int = 10, seed: int = 0,
                        train_blocks: int = 2,
                        train_sample: int = 1 << 18,
                        pq_train_sample: int = 1 << 18,
                        refine_m: int = 0,
                        opq_iters: int = 0,
                        spill_frac: float = 0.0,
                        device=None) -> "IVFPQIndex":
        """Build when the corpus is never whole on the device.

        ``block_fn(i) -> [block_rows, D]`` yields normalized corpus blocks
        (tensors, or host arrays moved to ``device``) and must be
        deterministic in ``i``: the corpus streams past twice (an assign
        pass keeping 4 B/row on the host, then an encode pass scattering
        codes straight into their cell-contiguous slots) and a third time
        for the refinement codes.

        ``spill_frac`` > 0 also encodes the ``spill_frac`` of rows with the
        smallest top-1 → top-2 coarse margin into their second-nearest
        cell; both copies carry the same original row, so searches dedupe
        them (``search``, ``exact_rerank``)."""
        rng = np.random.default_rng(seed)

        def get(i):
            return as_tensor(block_fn(i), device)

        # ---- 1. train coarse + codecs on sampled blocks
        tb = [get(i).float() for i in sorted(rng.choice(
            n_blocks, size=min(train_blocks, n_blocks), replace=False))]
        sample = torch.cat(tb) if len(tb) > 1 else tb[0]
        dev = sample.device
        if sample.shape[0] > train_sample:
            keep = np.sort(rng.choice(sample.shape[0], size=train_sample,
                                      replace=False))
            sample = sample[torch.as_tensor(keep, device=dev)]
        ns = int(sample.shape[0])
        nlist = max(1, min(nlist, ns))
        centroids, s_assign = kmeans(sample, nlist, iters=coarse_iters,
                                     seed=seed)
        s_assign = s_assign.long()
        # the codecs train on a subsample of the coarse-training sample
        pq_ns = min(ns, pq_train_sample)
        if pq_ns < ns:
            pk = torch.as_tensor(np.sort(rng.choice(ns, size=pq_ns,
                                                    replace=False)), device=dev)
            resid = sample[pk] - centroids[s_assign[pk]]
        else:
            resid = sample - centroids[s_assign]
        codec, codec2 = cls._train_codecs(
            resid, m, refine_m, ksub=ksub, pq_iters=pq_iters, seed=seed,
            ns=pq_ns, opq_iters=opq_iters)
        del sample, resid, tb

        # ---- pass A: assignments only.  bf16 inputs, f32 sums: a
        # nearest-centroid argmax, where input rounding moves only
        # knife-edge ties; the [rows, nlist] f32 scores stay ~1 GB
        a_chunk = max(8192, (1 << 28) // max(nlist, 1))
        cent_bf = centroids.to(torch.bfloat16).float()
        spill = float(spill_frac) > 0.0 and nlist > 1

        def assign_block(xb):
            firsts, seconds, margins = [], [], []
            for s in range(0, xb.shape[0], a_chunk):
                cs = xb[s:s + a_chunk].to(torch.bfloat16).float() @ cent_bf.T
                if spill:
                    v2, i2 = topk_lower_first(cs, 2)
                    firsts.append(i2[:, 0])
                    seconds.append(i2[:, 1])
                    margins.append(v2[:, 0] - v2[:, 1])
                else:
                    firsts.append(torch.argmax(cs, dim=1))
            out = [torch.cat(firsts).to(torch.int32).cpu().numpy()]
            if spill:
                out += [torch.cat(seconds).to(torch.int32).cpu().numpy(),
                        torch.cat(margins).cpu().numpy()]
            return out

        n = n_blocks * block_rows
        assign_h = np.empty((n,), np.int32)
        assign2_h = np.empty((n,), np.int32) if spill else None
        margin_h = np.empty((n,), np.float32) if spill else None
        for i in range(n_blocks):
            s = i * block_rows
            out = assign_block(get(i))
            assign_h[s: s + block_rows] = out[0]
            if spill:
                assign2_h[s: s + block_rows] = out[1]
                margin_h[s: s + block_rows] = out[2]

        # ---- layout on host over ENTRIES (rows + spilled duplicates);
        # block_rows maps slots to ORIGINAL rows
        if spill:
            tau = float(np.quantile(margin_h, spill_frac))
            extra = np.nonzero(margin_h <= tau)[0]   # sorted by row
            assign_ext = np.concatenate([assign_h, assign2_h[extra]])
        else:
            extra = np.zeros((0,), np.int64)
            assign_ext = assign_h
        n_ent = n + extra.shape[0]
        orig_ext = np.concatenate([np.arange(n, dtype=np.int64), extra])
        gather, cb = cell_block_layout(assign_ext, nlist, block)
        nb = gather.shape[0] // block
        dest = np.empty((n_ent,), np.int64)
        alive = gather >= 0
        dest[gather[alive]] = np.nonzero(alive)[0]
        gather = np.where(alive, orig_ext[np.clip(gather, 0, None)], -1)

        # ---- pass B: stage-1 encode + scatter into the final layout
        pack4 = ksub == 16
        mc = m // 2 if pack4 else m
        code_flat = torch.zeros((nb * block, mc), dtype=torch.uint8, device=dev)
        for i in range(n_blocks):
            s = i * block_rows
            xb = get(i)
            ab = torch.as_tensor(assign_h[s: s + block_rows], device=dev).long()
            code_flat[torch.as_tensor(dest[s: s + block_rows], device=dev)] = \
                _encode_residual(codec, m, xb.float() - centroids[ab], pack4)[1]
            js, je = np.searchsorted(extra, [s, s + block_rows])
            if je > js:
                # spilled duplicates: the SECOND-nearest cell's residual
                idx = torch.as_tensor(extra[js:je] - s, device=dev)
                cells = torch.as_tensor(assign2_h[extra[js:je]],
                                        device=dev).long()
                code_flat[torch.as_tensor(dest[n + js: n + je], device=dev)] = \
                    _encode_residual(codec, m,
                                     xb[idx].float() - centroids[cells],
                                     pack4)[1]

        # ---- pass C (refine only): decode the settled stage-1 codes back
        # (gathered by destination, no re-encode), PQ the leftover
        refine_codes = None
        if codec2 is not None:
            refine_codes = torch.empty(
                (n, refine_m // 2 if pack4 else refine_m), dtype=torch.uint8,
                device=dev)
            for i in range(n_blocks):
                s = i * block_rows
                ab = torch.as_tensor(assign_h[s: s + block_rows],
                                     device=dev).long()
                c1 = code_flat[torch.as_tensor(dest[s: s + block_rows],
                                               device=dev)]
                r2 = (get(i).float() - centroids[ab]) - codec.decode(
                    unpack_nibbles(c1) if pack4 else c1)
                refine_codes[s: s + block_rows] = _encode_residual(
                    codec2, refine_m, r2, pack4)[1]

        idx = cls(centroids, codec, code_flat.reshape(nb, block, mc),
                  gather.reshape(nb, block), cb, ids, refine_codec=codec2,
                  refine_codes=refine_codes)
        # with spill the slot count exceeds the row count (duplicates);
        # len() stays the number of DISTINCT rows
        idx._n_rows = n if ids is None else len(idx._ids)
        return idx

    # ------------------------------------------------------- block centroids
    def ensure_block_centroids(self, *, chunk_blocks: int = 256,
                               dtype=torch.float32, sub: int | None = None):
        """Per-block mini-centroids for block-budget probing, decoded from
        the stored codes: centroid(cell) + the mean decoded residual over
        each of ``sub`` slices of the block's valid rows, L2-normalized
        (all-pad slices zero).  Cached (the dtype included); saved.

        sub defaults to ``self.block_rank_sub``; dtype bf16 halves the
        [n_blocks*sub, D] matrix."""
        if sub is None:
            sub = self.block_rank_sub
        sub = max(1, int(sub))
        dtype = as_dtype(dtype)
        nb, blk, mc = self.code_blocks.shape
        if blk % sub:
            raise ValueError(f"block={blk} not divisible by sub={sub}")
        if (self.block_centroids is not None and self._bc_sub == sub
                and self.block_centroids.dtype == dtype):
            return self.block_centroids
        sb = blk // sub
        parts = []
        for s in range(0, nb, chunk_blocks):
            e = min(s + chunk_blocks, nb)
            cb = e - s
            flat = self.code_blocks[s:e].reshape(cb * blk, mc)
            if self.packed:
                flat = unpack_nibbles(flat)
            valid_c = self.block_rows_valid[s:e]              # [cB, blk]
            dec = self.codec.decode(flat).reshape(cb, blk, -1) \
                * valid_c[:, :, None]
            d = dec.shape[-1]
            cnt = valid_c.reshape(cb, sub, sb).sum(dim=2)     # [cB, sub]
            mean_r = dec.reshape(cb, sub, sb, d).sum(dim=2) \
                / torch.clamp(cnt, min=1.0)[:, :, None]       # [cB, sub, D]
            bc = self.centroids[self._block_cell_dev[s:e]][:, None, :] \
                + mean_r
            bc = bc * (cnt > 0).float()[:, :, None]
            bc = bc / torch.clamp(
                torch.linalg.vector_norm(bc, dim=2, keepdim=True), min=1e-12)
            parts.append(bc.reshape(cb * sub, d).to(dtype))
        self.block_centroids = torch.cat(parts)
        self._bc_sub = sub
        self.block_rank_sub = sub
        return self.block_centroids

    # ----------------------------------------------------------------- search
    def search_dispatch(self, queries, k: int = 10, *, nprobe: int = 64,
                        nprobe_blocks: int | None = None,
                        cell_gate: int | None = None,
                        bias=None, normalize_queries: bool = True,
                        vmem_budget_rows: int = 1 << 17,
                        refine_overfetch: int = 8,
                        extract: str = "auto",
                        hier_t: int = 64, adc_impl: str | None = None):
        """Device-only: → (vals [B, k] f32, original rows [B, k] i32, -1 for
        dead slots).  With a refinement stage, stage 1 over-fetches
        ``refine_overfetch * k`` candidates (at least 64) and the
        refinement ADC re-ranks them down to k.

        extract: "exact" (full top-k), "hier" (top-``hier_t`` per block,
        then an exact merge), "approx" (the strided layout of the JAX
        package's ApproxTopK path, extracted exactly), or "auto" (exact: the
        approximate extraction was a TPU choice).
        nprobe_blocks: probe by block budget (``_ivfpq_search_blocks``)
        instead of cell count; ``nprobe`` is then ignored.
        adc_impl: "kernel" (default on CUDA) or "plain" (default on CPU)."""
        q = as_tensor(queries, self.device).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        b = q.shape[0]
        if adc_impl is None:
            adc_impl = "kernel" if self.device.type == "cuda" else "plain"
        if adc_impl not in ADC_IMPLS:
            raise ValueError(f"unknown adc_impl {adc_impl!r}; "
                             f"expected one of {ADC_IMPLS}")
        nprobe = min(nprobe, self.nlist)
        max_bpc = int(self.cell_blocks.shape[1])
        if nprobe_blocks is not None:
            nprobe_blocks = int(min(nprobe_blocks, self.code_blocks.shape[0]))
            self.ensure_block_centroids()
            rows_per_q = max(nprobe_blocks * self.block, 1)
        else:
            rows_per_q = max(nprobe * max_bpc * self.block, 1)
        # small groups: each member re-scores the whole group's blocks
        group = max(1, min(4, vmem_budget_rows // rows_per_q, b))
        bb = None if bias is None else \
            as_tensor(bias, self.device).to(self.device, torch.float32)
        q, bb = pad_queries(q, bb, group)
        if normalize_queries:
            q = l2_normalize(q)
        bias_by_slot = None if bb is None else bias_to_block_layout(
            bb, self._block_rows_dev, self.block_rows_valid)
        k1 = k
        if self.refine_codec is not None:
            k1 = min(max(k * refine_overfetch, 64), rows_per_q)
        common = dict(group=group, adc_impl=adc_impl,
                      approx=extract == "approx",
                      hier_t=int(hier_t) if extract == "hier" else 0,
                      packed=self.packed)
        if nprobe_blocks is not None:
            vals, gpos = _ivfpq_search_blocks(
                q, self.centroids, self.block_centroids, self._block_cell_dev,
                self.code_blocks, self.block_rows_valid, self.codec.codebooks,
                self.codec.rotation, bias_by_slot, k=k1,
                nprobe_blocks=nprobe_blocks,
                cell_gate=None if cell_gate is None else int(cell_gate),
                sub=self._bc_sub, **common)
        else:
            vals, gpos = _ivfpq_search(
                q, self.centroids, self.code_blocks, self.block_rows_valid,
                self.cell_blocks, self.codec.codebooks, self.codec.rotation,
                bias_by_slot, k=k1, nprobe=nprobe, **common)
        vals, gpos = vals[:b], gpos[:b]
        rows = slots_to_rows(vals, gpos, self._block_rows_dev.reshape(-1))
        if self.refine_codec is not None:
            vals, rows = _refine_rescore(
                vals, rows, self.refine_codec.luts(q[:b]), self.refine_codes,
                k=k, packed=(self.refine_codec.ksub == 16 and
                             self.refine_codes.shape[1]
                             == self.refine_codec.m // 2))
        return vals, rows

    def search(self, queries, k: int = 10, *, nprobe: int = 64,
               nprobe_blocks: int | None = None,
               cell_gate: int | None = None, bias=None,
               normalize_queries: bool = True,
               vmem_budget_rows: int = 1 << 17,
               rerank_store=None, rerank_overfetch: int = 4,
               refine_overfetch: int | None = None, extract: str = "auto",
               hier_t: int = 64, adc_impl: str | None = None):
        """bias: f32 by ORIGINAL row — the contract of IVFIndex.search.

        rerank_store: optional ``HostVectorStore`` of the full vectors
        (row-aligned with this index): the device returns
        ``rerank_overfetch * k`` ADC candidates and the host re-scores them
        exactly.  With a rerank tier the refinement stage only reorders the
        candidates the host rescores, so it does not over-fetch."""
        if refine_overfetch is None:
            refine_overfetch = 1 if rerank_store is not None else 8
        k1 = k if rerank_store is None else max(k, rerank_overfetch * k)
        spill_dup = self._n_slots > self._n_rows
        if rerank_store is None and spill_dup:
            # spilled rows can take two of the top-k slots
            k1 = 2 * k
        vals, rows = self.search_dispatch(
            queries, k1, nprobe=nprobe, nprobe_blocks=nprobe_blocks,
            cell_gate=cell_gate, bias=bias,
            normalize_queries=normalize_queries,
            vmem_budget_rows=vmem_budget_rows,
            refine_overfetch=refine_overfetch, extract=extract,
            hier_t=hier_t, adc_impl=adc_impl)
        vals = vals.cpu().numpy()
        rows_out = rows.cpu().numpy()
        if rerank_store is not None:
            q = torch.as_tensor(queries).float().cpu().numpy()
            if q.ndim == 1:
                q = q[None, :]
            if normalize_queries:
                q = q / np.maximum(
                    np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            bias_h = None if bias is None else \
                torch.as_tensor(bias).float().cpu().numpy()
            vals, rows_out = exact_rerank(rerank_store, q, vals, rows_out,
                                          k=k, bias=bias_h)
        elif spill_dup:
            # no rerank tier: keep the better-scored copy of a spilled row
            dup = mark_duplicate_rows(rows_out)
            vals = np.where(dup, NEG_INF, vals)
            rows_out = np.where(dup, -1, rows_out)
            order = np.argsort(-vals, axis=1, kind="stable")
            vals = np.take_along_axis(vals, order, axis=1)[:, :k]
            rows_out = np.take_along_axis(rows_out, order, axis=1)[:, :k]
        ids_out = [
            [self._id_of(int(r)) if int(r) >= 0 else None for r in rr]
            for rr in rows_out
        ]
        return ids_out, vals, rows_out

    # -------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {}
        if self.refine_codec is not None:
            extra["refine_codebooks"] = self.refine_codec.codebooks.cpu().numpy()
            if self.refine_codec.rotation is not None:
                extra["refine_rotation"] = \
                    self.refine_codec.rotation.cpu().numpy()
            extra["refine_codes"] = self.refine_codes.cpu().numpy()
        if self.block_centroids is not None:
            # npz has no bf16: store the bits as uint16
            extra["block_centroids_u16"] = self.block_centroids.to(
                torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
        arrays = dict(
            centroids=self.centroids.cpu().numpy(),
            code_blocks=self.code_blocks.cpu().numpy(),
            block_rows=self.block_rows,
            cell_blocks=self.cell_blocks.to(torch.int32).cpu().numpy(),
            **self.codec.save_arrays(),
            **extra,
            meta=json.dumps({"ids": None if self._ids is None
                             else jsonable_ids(self._ids),
                             # distinct rows (slots > rows under spill)
                             "n_rows": self._n_rows}),
        )
        # PQ codes are near-uniform bytes: store big indexes uncompressed
        total = sum(getattr(a, "nbytes", 0) for a in arrays.values())
        savez = np.savez if total > (2 << 30) else np.savez_compressed
        savez(path, **arrays)

    @classmethod
    def load(cls, path: str, *, drop_refine: bool = False,
             device=None) -> "IVFPQIndex":
        """drop_refine: leave the refine codec and its codes on disk (safe
        whenever searches rerank exactly with ``refine_overfetch=1``)."""
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        codec = PQCodec.from_arrays(
            {"codebooks": z["codebooks"],
             **({"rotation": z["rotation"]} if "rotation" in z else {})},
            device=device)
        codec2 = refine_codes = None
        if not drop_refine and "refine_codebooks" in z:
            codec2 = PQCodec.from_arrays(
                {"codebooks": z["refine_codebooks"],
                 **({"rotation": z["refine_rotation"]}
                    if "refine_rotation" in z else {})}, device=codec.device)
            refine_codes = z["refine_codes"]
        bc = None
        if "block_centroids_u16" in z:
            bc = torch.from_numpy(np.asarray(z["block_centroids_u16"])
                                  .view(np.int16)).view(torch.bfloat16)
        elif "block_centroids" in z:   # older f32 checkpoints
            bc = z["block_centroids"]
        idx = cls(z["centroids"], codec, z["code_blocks"], z["block_rows"],
                  z["cell_blocks"], meta["ids"], refine_codec=codec2,
                  refine_codes=refine_codes, block_centroids=bc)
        if meta.get("n_rows") is not None:
            idx._n_rows = int(meta["n_rows"])
        return idx
