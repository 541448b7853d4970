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

Two things the upper layers do not know about the port's store, and the
caller wires once:

- ``/metrics`` renders the JAX package's registry: hand it to the port with
  ``archi_tpu_torch.utils.metrics.use_registry(archi_tpu.utils.metrics.METRICS)``;
- the JAX pipelines build their MaxSim rerank step only for an embedder
  with ``params``, so with ``retrievers.hybrid_retriever.rerank.enabled``
  they would return the over-fetched pool unranked: ``attach_reranker``
  gives each pipeline the port's reranker.
"""

from __future__ import annotations

import logging
import os

import torch

from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.bm25 import BM25Index
from archi_tpu_torch.engine.distributed import data_mesh
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.reranker import MaxSimReranker, RerankingRetriever
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex
from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.engine.xl_index import XlPQIndex
from archi_tpu_torch.models.registry import resolve_embedder
from archi_tpu_torch.utils.hardware import default_device

_logger = logging.getLogger(__name__)


def shard_devices(devices=None, device=None) -> list:
    """The shard devices of the multi-device types: ``devices`` when given;
    else ``[device]`` for a non-CUDA ``device`` (``"cpu"``); else every
    visible CUDA device (raising without CUDA)."""
    if devices is not None:
        return list(devices)
    if device is not None and torch.device(device).type != "cuda":
        return [device]
    return data_mesh()


def build_index(dim: int, index_cfg: dict, *, device=None, devices=None):
    """data_manager.index config → index instance, with the JAX package's
    defaults.

    type: "flat" (default) | "sharded" (corpus rows over ``devices``,
    per-shard fused top-k + merge, engine/sharded_index.py) | "ivf" (IVF
    snapshot + exact fresh-row tail, engine/ann_index.py) | "ivfpq" (the
    same with a PQ-compressed snapshot) | "ivfpq_xl" (host plane + PQ
    snapshot + exact tail, engine/xl_index.py) | "ivfpq_xl_sharded" (one
    XL index a device, engine/sharded_xl.py).  hot_tail: wrap appends in
    the segmented hot-tail path (engine/segmented_index.py).  ``devices``:
    the shard devices of the multi-device types (see ``shard_devices``; a
    device may repeat).
    """
    index_type = index_cfg.get("type", "flat")
    kw = dict(dtype=index_cfg.get("dtype", "bfloat16"),
              tile_n=index_cfg.get("tile_n", 4096))
    if index_type == "sharded":
        return ShardedFlatIndex(dim, devices=shard_devices(devices, device),
                                **kw)
    if index_type == "ivfpq_xl_sharded":
        # one XlPQIndex a device, per-shard host memmap rerank tier, global
        # merge
        return ShardedXlPQIndex(
            dim,
            devices=shard_devices(devices, device),
            store_dir=index_cfg.get("store_dir"),
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
            build_block_rows=index_cfg.get("build_block_rows", 1 << 17),
            **kw)
    kw["device"] = default_device(device)
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
    # every other type restores through FlatIndex.load, as the JAX package
    # does: a `sharded` checkpoint (FlatIndex's layout) comes back as a
    # single-device FlatIndex; an XL checkpoint (sharded or not) has no
    # FlatIndex meta, so it raises and the caller builds afresh
    return TorchVectorStore.load(checkpoint_dir, embedder, device=device,
                                 index_cls=index_cls,
                                 index_loader=index_loader)


def _rerank_settings(dm_cfg: dict):
    """(rerank enabled, k) from ``retrievers.hybrid_retriever``."""
    hybrid = (dm_cfg.get("retrievers") or {}).get("hybrid_retriever") or {}
    return (bool((hybrid.get("rerank") or {}).get("enabled")),
            hybrid.get("num_documents_to_retrieve", 5))


def attach_reranker(pipeline, dm_cfg: dict | None = None) -> bool:
    """Give a built pipeline the port's MaxSim rerank step.

    With ``retrievers.hybrid_retriever.rerank.enabled`` in ``dm_cfg``
    (default: the pipeline's ``dm_config``), the pipeline's ``retriever``
    (which the pipeline already built with k raised to the over-fetch) is
    wrapped in ``RerankingRetriever(retriever, MaxSimReranker(store's
    embedder), k=num_documents_to_retrieve)``, now and after every
    ``update_retriever`` call (the orchestrator rebuilds the retriever on
    each request).  Duck-typed: any object with ``retriever`` and
    ``update_retriever(vectorstore, enabled_ids=None)``.  Returns whether
    the rerank is on."""
    enabled, k = _rerank_settings(
        getattr(pipeline, "dm_config", {}) if dm_cfg is None else dm_cfg)
    if not enabled:
        return False

    def wrap():
        base = pipeline.retriever
        if base is None or getattr(base, "reranker", None) is not None:
            return
        embedder = base.vectorstore._embedding_function
        pipeline.retriever = RerankingRetriever(
            base, MaxSimReranker(embedder), k=k)

    update = pipeline.update_retriever

    def update_retriever(vectorstore, enabled_ids=None):
        update(vectorstore, enabled_ids)
        wrap()

    pipeline.update_retriever = update_retriever
    wrap()
    return True


def build_vectorstore(dm_cfg: dict, *, device=None,
                      devices=None) -> TorchVectorStore:
    """data_manager config section → the port's ``TorchVectorStore``.

    Resolves the embedder through the port's registry, restores
    ``<data_path>/engine_checkpoint`` when it exists (a restore that fails
    is logged and the store is built afresh, as in the JAX package), and
    turns on ``serving.micro_batch`` with the reference's defaults
    (max_batch 32, max_wait_ms 4.0, workers 2).  ``devices``: the shard
    devices of the multi-device index types (``build_index``).  With
    ``retrievers.hybrid_retriever.rerank.enabled`` it logs an error: the
    JAX pipelines skip the rerank over this store unless the caller wraps
    them with ``attach_reranker``."""
    if device is None and devices:
        device = devices[0]
    device = default_device(device)
    if _rerank_settings(dm_cfg)[0]:
        _logger.error(
            "retrievers.hybrid_retriever.rerank.enabled: the JAX pipelines "
            "skip the MaxSim rerank over the port's store and return the "
            "over-fetched pool; wrap each pipeline with "
            "archi_tpu_torch.bin.bootstrap.attach_reranker(pipeline)")
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
            index=build_index(embedder.dim, index_cfg, device=device,
                              devices=devices),
            bm25=BM25Index(stemming=stemming, device=device),
            device=device)
    mb_cfg = (dm_cfg.get("serving") or {}).get("micro_batch") or {}
    if mb_cfg.get("enabled"):
        store.enable_micro_batching(
            max_batch=mb_cfg.get("max_batch", 32),
            max_wait_ms=mb_cfg.get("max_wait_ms", 4.0),
            workers=mb_cfg.get("workers", 2))
    return store
