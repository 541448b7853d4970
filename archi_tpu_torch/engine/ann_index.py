"""ANN-accelerated serving index: IVF / IVF-PQ snapshot + exact fresh tail.

Counterpart of ``archi_tpu/engine/ann_index.py``: ingest stays on the
incremental ``FlatIndex`` plane, and queries run against a periodically
refreshed snapshot of the corpus prefix (``IVFIndex`` for
``snapshot_kind="ivf"``, ``IVFPQIndex`` for ``"ivfpq"``) plus an EXACT scan
of the rows added since the snapshot (the fused top-k kernel), merged on
the device.

The additive-bias contract survives the ANN: tombstones, metadata filters,
enablement and hybrid BM25 ride the same per-row bias, permuted into block
layout by one gather.  At ``nprobe == nlist`` an ``ivf`` snapshot is exact.
For ``ivfpq`` the ADC candidates (``rerank_overfetch * k``) are re-scored
exactly against the full-precision rows already on the device.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import torch

from archi_tpu_torch.engine.flat_index import FlatIndex, l2_normalize
from archi_tpu_torch.engine.ivf_index import IVFIndex
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
from archi_tpu_torch.engine.topk import (alive_to_bias, pad_bias_rows,
                                         topk_lower_first, topk_scores)

logger = logging.getLogger(__name__)


def _exact_rescore(emb, queries, vals, rows, row_bias, *, k, int8=False):
    """Exact rerank of ANN candidates against the full-precision rows on
    the device.  vals/rows [B, C] (NEG_INF = dead, stays dead); row_bias
    [capacity] or [B, capacity].  → (vals [B, k], rows [B, k])."""
    safe = torch.clamp(rows.long(), 0, emb.shape[0] - 1)
    cand = emb[safe].float()                                   # [B, C, D]
    if int8:
        cand = cand / 127.0
    ex = torch.einsum("bcd,bd->bc", cand, queries.float())
    if row_bias.dim() == 2:
        ex = ex + torch.gather(row_bias, 1, safe)
    else:
        ex = ex + row_bias[safe]
    scores = torch.where(vals > -1e29, ex, vals)
    top_vals, pos = topk_lower_first(scores, k)
    return top_vals, torch.gather(rows, 1, pos)


def _merge_topk(a_vals, a_rows, f_vals, f_rows, n_snap: int):
    """Disjoint-range merge: ANN rows < n_snap, fresh rows are tail-relative
    (shifted here).  → top-k of the union, k = a_vals' width."""
    vals = torch.cat([a_vals, f_vals], dim=1)
    rows = torch.cat([a_rows.to(torch.int32), torch.where(
        f_vals > -1e29, f_rows + n_snap, -1).to(torch.int32)], dim=1)
    top_vals, pos = topk_lower_first(vals, a_vals.shape[1])
    return top_vals, torch.gather(rows, 1, pos)


class AnnFlatIndex(FlatIndex):
    """FlatIndex whose searches are IVF-accelerated over a snapshot.

    Args (beyond FlatIndex):
      nlist / nprobe: IVF cells and default probes.
      nprobe_blocks / cell_gate / block_rank_sub: block-budget probing of
        an ``ivfpq`` snapshot (see ``IVFPQIndex.search_dispatch``).
      min_snapshot_rows: corpus size before the first snapshot is built.
      refresh_fraction: rebuild when fresh rows exceed this fraction of the
        snapshot (fresh rows are scanned exactly meanwhile).
      snapshot_kind: "ivf" (full-precision cells) or "ivfpq" (PQ-coded
        residual cells + refinement; pq_m / pq_refine_m apply).
      rerank_overfetch: ivfpq only — exact rescore of
        ``rerank_overfetch * k`` ADC candidates; 0 disables.
      extract / hier_t: stage-1 extraction of the PQ snapshot.
      async_refresh: rebuild on a background thread, serving the stale
        snapshot + exact tail meanwhile.
      adc_impl: the PQ snapshot's ADC ("kernel" by default on CUDA,
        "plain" for the plain versions).
    """

    #: per-query [B, N] bias permutes into block layout per query
    supports_batched_bias = True

    def __init__(self, dim: int, *, nlist: int = 1024, nprobe: int = 64,
                 nprobe_blocks: int | None = None,
                 cell_gate: int | None = None,
                 block_rank_sub: int = 8,
                 min_snapshot_rows: int = 1 << 15,
                 refresh_fraction: float = 0.25,
                 snapshot_kind: str = "ivf", pq_m: int = 48,
                 pq_refine_m: int = 48, rerank_overfetch: int = 4,
                 extract: str = "auto", hier_t: int = 64,
                 async_refresh: bool = True, adc_impl: str | None = None,
                 **kw):
        super().__init__(dim, **kw)
        if snapshot_kind not in ("ivf", "ivfpq"):
            raise ValueError(f"unknown snapshot_kind {snapshot_kind!r}")
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.nprobe_blocks = (None if nprobe_blocks is None
                              else int(nprobe_blocks))
        self.cell_gate = None if cell_gate is None else int(cell_gate)
        self.block_rank_sub = max(1, int(block_rank_sub))
        self.min_snapshot_rows = int(min_snapshot_rows)
        self.refresh_fraction = float(refresh_fraction)
        self.snapshot_kind = snapshot_kind
        self.pq_m = int(pq_m)
        self.pq_refine_m = int(pq_refine_m)
        self.rerank_overfetch = int(rerank_overfetch)
        self.extract = str(extract)
        self.hier_t = int(hier_t)
        self.async_refresh = bool(async_refresh)
        self.adc_impl = adc_impl
        self._ivf = None  # IVFIndex | IVFPQIndex
        self._n_snap = 0
        self._ann_lock = threading.Lock()     # guards (_ivf, _n_snap) swaps
        self._build_lock = threading.Lock()   # serializes rebuilds
        self._compact_epoch = 0
        self._refresh_thread: threading.Thread | None = None
        self._kick_lock = threading.Lock()

    # ---------------------------------------------------------------- refresh
    def _needs_refresh(self) -> bool:
        if self.n_rows < self.min_snapshot_rows:
            return False
        fresh = self.n_rows - self._n_snap
        return fresh > max(self.refresh_fraction * max(self._n_snap, 1),
                           0 if self._ivf is None else 1)

    def _snapshot_search(self, ivf, queries, k, **kw):
        if self.snapshot_kind == "ivfpq":
            kw["adc_impl"] = self.adc_impl
        return ivf.search_dispatch(queries, k=k, **kw)

    def _warm(self, ivf) -> None:
        """One probe search through a new snapshot before it serves."""
        probe = torch.zeros((1, self.dim), dtype=torch.float32,
                            device=self.device)
        self._snapshot_search(ivf, probe, 10, nprobe=self.nprobe)

    def _load_snapshot(self, path: str):
        if self.snapshot_kind == "ivfpq":
            ivf = IVFPQIndex.load(path, device=self.device)
            ivf.block_rank_sub = self.block_rank_sub
            return ivf
        return IVFIndex.load(path, device=self.device)

    def refresh_ann(self) -> None:
        """Rebuild the snapshot from the current corpus prefix.  The build
        runs outside ``_ann_lock`` (searches keep serving the old snapshot);
        a compact() racing the build bumps ``_compact_epoch`` and the stale
        snapshot is discarded instead of swapped in."""
        with self._build_lock:
            n = self.n_rows
            if n < self.min_snapshot_rows:
                return
            epoch = self._compact_epoch
            with self._buf_lock:
                emb_snap = self.emb
            x = self._rows_f32(n) if self.dtype == torch.int8 else emb_snap[:n]
            if self.snapshot_kind == "ivfpq":
                ivf = IVFPQIndex.build_device(
                    x, nlist=min(self.nlist, n), block=512,
                    m=self.pq_m, refine_m=self.pq_refine_m)
                ivf.block_rank_sub = self.block_rank_sub
            else:
                ivf = IVFIndex.build_device(
                    x, nlist=min(self.nlist, n), block=512,
                    dtype=self.dtype if self.dtype != torch.int8
                    else torch.bfloat16)
            try:
                self._warm(ivf)
            except Exception:
                logger.exception("ANN snapshot warmup failed (serving "
                                 "continues)")
            with self._ann_lock:
                if self._compact_epoch != epoch:
                    logger.info("ANN snapshot discarded: compaction "
                                "renumbered rows during the build")
                    return
                self._ivf, self._n_snap = ivf, n
            logger.info("ANN snapshot refreshed (%s): %d rows, nlist=%d",
                        self.snapshot_kind, n, ivf.nlist)

    def compact(self) -> None:
        """Compaction renumbers physical rows: the snapshot's row map would
        point at the old numbering, so it is dropped (the next search
        rebuilds from the compacted corpus)."""
        super().compact()
        with self._ann_lock:
            self._ivf = None
            self._n_snap = 0
            self._compact_epoch += 1

    # ------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        """Rows (FlatIndex) + the snapshot sidecars (``.ann.npz``,
        ``.ann.json``) when the save has no tombstones (``load`` compacts
        them, which renumbers rows).  Stale sidecars are removed first."""
        for sfx in (".ann.npz", ".ann.json"):
            try:
                os.remove(path + sfx)
            except FileNotFoundError:
                pass
        super().save(path)
        with self._ann_lock:
            ivf, n_snap = self._ivf, self._n_snap
        if ivf is not None and self._n_dead == 0:
            ivf.save(path + ".ann.npz")
            with open(path + ".ann.json", "w") as f:
                json.dump({"n_snap": int(n_snap),
                           "kind": self.snapshot_kind}, f)

    @classmethod
    def load(cls, path: str, **extra) -> "AnnFlatIndex":
        idx = super().load(path, **extra)
        meta_p, snap_p = path + ".ann.json", path + ".ann.npz"
        if os.path.exists(meta_p) and os.path.exists(snap_p):
            try:
                with open(meta_p) as f:
                    m = json.load(f)
                if m.get("kind") == idx.snapshot_kind \
                        and m.get("n_snap", 0) <= idx.n_rows:
                    idx._ivf = idx._load_snapshot(snap_p)
                    idx._n_snap = int(m["n_snap"])
            except Exception:
                logger.exception("ANN snapshot sidecar unreadable; "
                                 "will rebuild")
        return idx

    # ------------------------------------------- out-of-process building
    def export_corpus(self, path: str) -> None:
        """Checkpoint the corpus for an out-of-process snapshot build; the
        export records the compaction epoch so a snapshot whose row
        numbering went stale is refused at ``adopt_snapshot``."""
        with self._buf_lock:
            n = self.n_rows
        FlatIndex.save(self, path)           # rows only, no ANN sidecar
        with open(path + ".export.json", "w") as f:
            json.dump({"epoch": self._compact_epoch, "n_rows": int(n),
                       "kind": self.snapshot_kind}, f)

    def adopt_snapshot(self, path: str, *, warm: bool = True) -> bool:
        """Swap in a snapshot built out-of-process from ``export_corpus``
        output.  → True if adopted; False (logged) when the export is stale
        (compaction since export, kind mismatch, missing files)."""
        meta_p, snap_p = path + ".ann.json", path + ".ann.npz"
        exp_p = path + ".export.json"
        if not (os.path.exists(meta_p) and os.path.exists(snap_p)):
            logger.warning("adopt_snapshot: no sidecar at %s", path)
            return False
        try:
            with open(meta_p) as f:
                m = json.load(f)
            exp = {}
            if os.path.exists(exp_p):
                with open(exp_p) as f:
                    exp = json.load(f)
            if m.get("kind") != self.snapshot_kind:
                logger.warning("adopt_snapshot: kind %s != %s",
                               m.get("kind"), self.snapshot_kind)
                return False
            if exp.get("epoch", self._compact_epoch) != self._compact_epoch:
                logger.warning("adopt_snapshot: corpus compacted since "
                               "export; snapshot row numbering is stale")
                return False
            if m.get("n_snap", 0) > self.n_rows:
                logger.warning("adopt_snapshot: snapshot covers %s rows, "
                               "index has %s", m.get("n_snap"), self.n_rows)
                return False
            ivf = self._load_snapshot(snap_p)
        except Exception:
            logger.exception("adopt_snapshot: unreadable sidecar")
            return False
        if warm:
            try:
                self._warm(ivf)
            except Exception:
                logger.exception("adopted-snapshot warmup failed")
        with self._ann_lock:
            self._ivf, self._n_snap = ivf, int(m["n_snap"])
        logger.info("adopted out-of-process ANN snapshot: %d rows",
                    self._n_snap)
        return True

    def _kick_refresh(self) -> None:
        """Start a background rebuild unless one is running (atomic
        check-and-spawn)."""
        def guarded():
            try:
                self.refresh_ann()
            except Exception:
                # serving continues on the exact path / stale snapshot,
                # and the next search re-kicks
                logger.exception("background ANN refresh failed; "
                                 "serving continues, will retry")

        with self._kick_lock:
            t = self._refresh_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=guarded, name="ann-refresh",
                                 daemon=True)
            self._refresh_thread = t
            t.start()

    # ---------------------------------------------------------------- search
    def search(self, queries, k: int = 10, *, filter_mask=None, bias=None,
               nprobe: int | None = None):
        if self._needs_refresh():
            if self.async_refresh:
                self._kick_refresh()
            else:
                self.refresh_ann()
        with self._ann_lock:
            ivf, n_snap = self._ivf, self._n_snap
        if ivf is None:
            return super().search(queries, k, filter_mask=filter_mask,
                                  bias=bias)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        if self.normalize:
            q = l2_normalize(q)

        # combined per-row bias over global rows (the FlatIndex's math)
        with self._buf_lock:
            emb_snap, alive_snap, n_rows = self.emb, self.alive, self.n_rows
        cap = alive_snap.shape[0]
        alive = alive_snap
        if filter_mask is not None:
            fm = torch.as_tensor(filter_mask).to(self.device, torch.float32)
            alive = alive * pad_bias_rows(fm, cap)
        row_bias = alive_to_bias(alive)
        if bias is not None:
            b = torch.as_tensor(bias).to(self.device, torch.float32)
            row_bias = row_bias + pad_bias_rows(b, cap)

        k_eff = min(k, max(len(self), 1))
        # ANN over the snapshot (bias permuted to block layout inside;
        # queries already normalized: scaled hybrids are not re-normalized)
        pq = self.snapshot_kind == "ivfpq"
        rr = self.rerank_overfetch if pq else 0
        k_ann = max(k_eff, rr * k_eff) if rr else k_eff
        k_ann = min(k_ann, max(n_snap, 1))
        extra = {}
        if pq:
            if self.nprobe_blocks is not None:
                extra["nprobe_blocks"] = self.nprobe_blocks
                if self.cell_gate is not None:
                    extra["cell_gate"] = self.cell_gate
            if rr:
                # stage 1 returns exactly the rescore candidates: the
                # refinement rescore would only reorder them
                extra["refine_overfetch"] = 1
            extra["extract"] = self.extract
            extra["hier_t"] = self.hier_t
        a_vals, a_rows = self._snapshot_search(
            ivf, q, k_ann, nprobe=nprobe or self.nprobe, bias=row_bias,
            normalize_queries=False, **extra)
        if rr and k_ann > k_eff:
            a_vals, a_rows = _exact_rescore(
                emb_snap, q, a_vals, a_rows, row_bias, k=k_eff,
                int8=self.dtype == torch.int8)
        # EXACT scan of the fresh rows [n_snap, n_rows) by the fused kernel
        f_vals, f_rows = topk_scores(q, emb_snap[n_snap:], row_bias[..., n_snap:],
                                     n_rows - n_snap, k=k_eff)
        vals, rows = _merge_topk(a_vals, a_rows, f_vals, f_rows, n_snap)
        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()
        ids = [
            [self._ids[r] if (v > -1e29 and 0 <= r < len(self._ids))
             else None
             for r, v in zip(rr_, vv)]
            for rr_, vv in zip(rows, vals)
        ]
        return ids, vals, rows
