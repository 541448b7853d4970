"""Build the port's vector store from a ``data_manager`` config section.

Counterpart of the engine half of ``archi_tpu/bin/bootstrap.py``
(``_build_index`` and the store part of ``build_context``): resolve the
embedder, restore ``<data_path>/engine_checkpoint`` or build a fresh index,
and turn on ``serving.micro_batch``.  The framework-free upper layers (data
manager, web apps) take the result through their injection point, on a
machine that has them::

    store = build_vectorstore(config["data_manager"])
    ctx = archi_tpu.bin.bootstrap.build_context(overrides=config,
                                                vectorstore=store)

The device is an argument: the card by default (raising without CUDA), or
``"cpu"``.  No environment variable moves the port to the CPU.
"""

from __future__ import annotations

import logging
import os

from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.bm25 import BM25Index
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.engine.xl_index import XlPQIndex
from archi_tpu_torch.models.registry import resolve_embedder
from archi_tpu_torch.utils.hardware import default_device

_logger = logging.getLogger(__name__)


def build_index(dim: int, index_cfg: dict, *, device=None):
    """data_manager.index config → index instance, with the JAX package's
    defaults.

    type: "flat" (default) | "ivf" (IVF snapshot + exact fresh-row tail,
    engine/ann_index.py) | "ivfpq" (the same with a PQ-compressed snapshot)
    | "ivfpq_xl" (host plane + PQ snapshot + exact tail,
    engine/xl_index.py).  hot_tail: wrap appends in the segmented hot-tail
    path (engine/segmented_index.py).  The multi-device types ("sharded",
    "ivfpq_xl_sharded") are not ported yet.
    """
    device = default_device(device)
    kw = dict(dtype=index_cfg.get("dtype", "bfloat16"),
              tile_n=index_cfg.get("tile_n", 4096), device=device)
    index_type = index_cfg.get("type", "flat")
    if index_type in ("sharded", "ivfpq_xl_sharded"):
        raise NotImplementedError(
            f"index type {index_type!r} needs the multi-device tier, which "
            "the port does not have yet (ROADMAP.md, queue A, item 15)")
    if index_type == "ivfpq_xl":
        return XlPQIndex(
            dim,
            store_path=index_cfg.get("store_path"),
            nlist=index_cfg.get("nlist", 4096),
            block=index_cfg.get("block", 512),
            pq_m=index_cfg.get("pq_m", 48),
            pq_refine_m=index_cfg.get("pq_refine_m", 48),
            nprobe_blocks=index_cfg.get("nprobe_blocks") or 128,
            cell_gate=index_cfg.get("cell_gate"),
            block_rank_sub=index_cfg.get("block_rank_sub", 8),
            extract=index_cfg.get("extract", "auto"),
            hier_t=index_cfg.get("hier_t", 64),
            rerank_overfetch=index_cfg.get("rerank_overfetch", 16),
            min_snapshot_rows=index_cfg.get("min_snapshot_rows", 1 << 17),
            async_refresh=index_cfg.get("async_refresh", True),
            **kw)
    if index_type in ("ivf", "ivfpq"):
        return AnnFlatIndex(
            dim,
            nlist=index_cfg.get("nlist", 1024),
            nprobe=index_cfg.get("nprobe", 64),
            nprobe_blocks=index_cfg.get("nprobe_blocks"),
            cell_gate=index_cfg.get("cell_gate"),
            block_rank_sub=index_cfg.get("block_rank_sub", 8),
            min_snapshot_rows=index_cfg.get("min_snapshot_rows", 1 << 15),
            snapshot_kind=index_type,
            pq_m=index_cfg.get("pq_m", 48),
            pq_refine_m=index_cfg.get("pq_refine_m", 48),
            extract=index_cfg.get("extract", "auto"),
            hier_t=index_cfg.get("hier_t", 64),
            async_refresh=index_cfg.get("async_refresh", True),
            **kw)
    if index_cfg.get("hot_tail"):
        return SegmentedFlatIndex(
            dim, merge_rows=index_cfg.get("merge_rows", 1 << 16), **kw)
    return FlatIndex(dim, **kw)


def _restore(checkpoint_dir: str, embedder, index_cfg: dict, device):
    """The checkpointed store, restored with the configured index type (the
    JAX package's choice of ``index_cls`` / ``index_loader``)."""
    index_cls = index_loader = None
    itype = index_cfg.get("type", "flat")
    if itype in ("ivf", "ivfpq"):
        # restart keeps the configured ANN mode (and reuses the
        # checkpointed snapshot sidecar when present, skipping the rebuild)
        def index_loader(p):
            return AnnFlatIndex.load(
                p,
                nlist=index_cfg.get("nlist", 1024),
                nprobe=index_cfg.get("nprobe", 64),
                min_snapshot_rows=index_cfg.get("min_snapshot_rows", 1 << 15),
                snapshot_kind=itype,
                pq_m=index_cfg.get("pq_m", 48),
                pq_refine_m=index_cfg.get("pq_refine_m", 48),
                async_refresh=index_cfg.get("async_refresh", True),
                device=device)
    elif index_cfg.get("hot_tail"):
        index_cls = SegmentedFlatIndex
    # every other type (ivfpq_xl included) restores through FlatIndex.load,
    # as the JAX package does; an XL checkpoint has no FlatIndex meta, so it
    # raises and the caller builds afresh
    return TorchVectorStore.load(checkpoint_dir, embedder, device=device,
                                 index_cls=index_cls,
                                 index_loader=index_loader)


def build_vectorstore(dm_cfg: dict, *, device=None) -> TorchVectorStore:
    """data_manager config section → the port's ``TorchVectorStore``.

    Resolves the embedder through the port's registry, restores
    ``<data_path>/engine_checkpoint`` when it exists (a restore that fails
    is logged and the store is built afresh, as in the JAX package), and
    turns on ``serving.micro_batch`` with the reference's defaults
    (max_batch 32, max_wait_ms 4.0, workers 2)."""
    device = default_device(device)
    embedder = resolve_embedder(dm_cfg, device=device)
    index_cfg = dm_cfg.get("index") or {}
    checkpoint_dir = os.path.join(dm_cfg["data_path"], "engine_checkpoint")
    store = None
    if os.path.isdir(checkpoint_dir):
        # restart-resume: reload embeddings instead of re-embedding the
        # corpus (the catalog diff-sync reconciles any drift after load)
        try:
            store = _restore(checkpoint_dir, embedder, index_cfg, device)
        except Exception:
            _logger.exception("engine checkpoint %s did not restore; "
                              "building a fresh store", checkpoint_dir)
    if store is None:
        stemming = bool((dm_cfg.get("stemming") or {}).get("enabled"))
        store = TorchVectorStore(
            embedder,
            index=build_index(embedder.dim, index_cfg, device=device),
            bm25=BM25Index(stemming=stemming, device=device),
            device=device)
    mb_cfg = (dm_cfg.get("serving") or {}).get("micro_batch") or {}
    if mb_cfg.get("enabled"):
        store.enable_micro_batching(
            max_batch=mb_cfg.get("max_batch", 32),
            max_wait_ms=mb_cfg.get("max_wait_ms", 4.0),
            workers=mb_cfg.get("workers", 2))
    return store
