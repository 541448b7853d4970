"""Service bootstrap of the port: build the services' stack from a config.

Counterpart of ``archi_tpu/bin/bootstrap.py``.  ``build_vectorstore`` turns
a ``data_manager`` config section into the port's store (resolve the
embedder, restore ``<data_path>/engine_checkpoint`` or build a fresh index,
turn on ``serving.micro_batch``); ``build_context`` builds on it what the
two services run (``bin/service_data_manager.py``, ``bin/service_chat.py``):
the merged config with the providers configured, the app database, the
config service, the users, conversations, traces and prompts, the catalog,
the store, the data manager, the scheduler and BYOK.  The JAX package's
Postgres backends are not ported yet.

Two departures from the JAX package's ``build_context``:

- BYOK stores keys Fernet-encrypted, which needs ``cryptography``.  Where
  it does not import, ``byok_store`` and ``byok_resolver`` are ``None``, with one logged warning that names the
  package: the chat app's BYOK routes then answer 501 "BYOK not
  configured".  A key is never stored in clear instead.
- ``serving.micro_batch`` is applied only to a store that can batch.  A
  chat process in remote mode is handed a ``RemoteVectorStore`` (the
  data-manager it queries batches for it), so one deployment config serves
  both services; the JAX package raises ``AttributeError`` there.

On a machine with JAX the JAX package's upper layers take the port's store
too::

    store = build_vectorstore(config["data_manager"])
    ctx = archi_tpu.bin.bootstrap.build_context(overrides=config,
                                                vectorstore=store)

The device is an argument: the card by default (raising without CUDA), or
``"cpu"``.  No environment variable moves the port to the CPU.

Two things the JAX package's upper layers do not know about the port's
store, and a caller that injects it there wires once:

- their ``/metrics`` renders the JAX package's registry: hand it to the
  port with
  ``archi_tpu_torch.utils.metrics.use_registry(archi_tpu.utils.metrics.METRICS)``
  (the port's own services render the port's registry);
- the JAX pipelines build their MaxSim rerank step only for an embedder
  with ``params``, so with ``retrievers.hybrid_retriever.rerank.enabled``
  they would return the over-fetched pool unranked: ``attach_reranker``
  gives each pipeline the port's reranker (the port's own pipelines build
  it themselves, ``pipelines/base.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

from archi_tpu_torch.config.manager import ConfigurationManager
from archi_tpu_torch.config.service import ConfigService
from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.data_manager import DataManager
from archi_tpu_torch.data.scheduler import CronScheduler
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
from archi_tpu_torch.providers.byok import BYOKResolver, BYOKStore
from archi_tpu_torch.providers.registry import configure_providers
from archi_tpu_torch.utils.app_db import AppDatabase
from archi_tpu_torch.utils.conversation_service import ConversationService
from archi_tpu_torch.utils.hardware import default_device
from archi_tpu_torch.utils.logging_utils import setup_logging
from archi_tpu_torch.utils.prompt_service import PromptService
from archi_tpu_torch.utils.trace_service import TraceService
from archi_tpu_torch.utils.user_service import UserService

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
    ``retrievers.hybrid_retriever.rerank.enabled`` it logs a warning for a
    caller that hands the store to the JAX package's pipelines: they skip
    the rerank over this store unless wrapped with ``attach_reranker`` (the
    port's own pipelines rerank)."""
    if device is None and devices:
        device = devices[0]
    device = default_device(device)
    if _rerank_settings(dm_cfg)[0]:
        _logger.warning(
            "retrievers.hybrid_retriever.rerank.enabled: the JAX package's "
            "pipelines skip the MaxSim rerank over the port's store and "
            "return the over-fetched pool; wrap each of them with "
            "archi_tpu_torch.bin.bootstrap.attach_reranker(pipeline) (the "
            "port's own pipelines rerank)")
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
    _micro_batching(store, dm_cfg)
    return store


def _micro_batching(store, dm_cfg: dict) -> None:
    """Turn on ``serving.micro_batch`` when the config enables it, on a
    store that can batch: a ``RemoteVectorStore`` is passed by (the
    data-manager it queries batches)."""
    mb_cfg = (dm_cfg.get("serving") or {}).get("micro_batch") or {}
    if mb_cfg.get("enabled") and hasattr(store, "enable_micro_batching"):
        store.enable_micro_batching(
            max_batch=mb_cfg.get("max_batch", 32),
            max_wait_ms=mb_cfg.get("max_wait_ms", 4.0),
            workers=mb_cfg.get("workers", 2))


@dataclasses.dataclass
class ServiceContext:
    """What the data-manager and the chat service run on (the JAX
    package's ``ServiceContext``).  ``vectorstore`` is a
    ``TorchVectorStore``, or a ``RemoteVectorStore`` in a chat process in
    remote mode; ``byok_store`` and ``byok_resolver`` are ``None`` without
    ``cryptography``."""
    config: dict
    app_db: AppDatabase
    config_service: ConfigService
    users: UserService
    conversations: ConversationService
    traces: TraceService
    prompts: PromptService
    catalog: CatalogService
    vectorstore: TorchVectorStore
    data_manager: DataManager
    scheduler: CronScheduler
    byok_store: Optional[BYOKStore]
    byok_resolver: Optional[BYOKResolver]


def open_byok_store(path: str) -> Optional[BYOKStore]:
    """The encrypted BYOK store at ``path`` (keyed by ``ARCHI_SECRET``), or
    ``None``, with one logged warning, where ``cryptography`` does not
    import."""
    try:
        import cryptography.fernet  # noqa: F401
    except ImportError:
        _logger.warning(
            "BYOK disabled: the package 'cryptography' does not import, and "
            "user API keys are stored only encrypted; the BYOK routes answer "
            "501")
        return None
    secret = os.environ.get("ARCHI_SECRET", "archi-tpu-dev-secret")
    return BYOKStore(path, secret=secret)


def open_app_database(path: str) -> AppDatabase:
    """The SQLite app database at ``path``.  A Postgres DSN raises: the
    Postgres backends are not ported yet, and a DSN is never served by a
    SQLite file instead."""
    if path.startswith(("postgres://", "postgresql://")):
        raise NotImplementedError(
            f"app_db {path.split('@')[-1]!r}: the Postgres backends "
            "(utils/app_db_postgres.py, utils/connection_pool.py, "
            "data/catalog_postgres.py) are not ported to archi_tpu_torch "
            "yet (ROADMAP.md queue A).  Point app_db at a SQLite path")
    return AppDatabase(path)


def build_context(config_paths=(), overrides: Optional[dict] = None, *,
                  vectorstore: Optional[TorchVectorStore] = None,
                  device=None, devices=None) -> ServiceContext:
    """Config files (YAML, which needs PyYAML) merged under ``overrides``
    over the defaults → the services' context.

    ``vectorstore``: a store built by the caller, a ``TorchVectorStore``
    (the config's ``serving.micro_batch`` is applied to it, as the JAX
    package does) or a ``RemoteVectorStore`` (left as it is); else
    ``build_vectorstore(config["data_manager"], device=device,
    devices=devices)``, which restores ``<data_path>/engine_checkpoint``
    when it exists.  ``app_db`` (default ``<data_path>/app.db``) is a
    SQLite path; BYOK keys go to ``<data_path>/byok.db``."""
    cm = ConfigurationManager(config_paths, overrides)
    cm.validate()
    config = cm.config
    setup_logging(config.get("verbosity"))
    configure_providers(config.get("providers", {}))

    dm_cfg = config["data_manager"]
    data_path = dm_cfg["data_path"]
    os.makedirs(data_path, exist_ok=True)
    app_db = open_app_database(
        config.get("app_db") or os.path.join(data_path, "app.db"))
    config_service = ConfigService(app_db)
    config_service.seed(config)

    catalog = CatalogService(dm_cfg["db_path"])
    if vectorstore is None:
        vectorstore = build_vectorstore(dm_cfg, device=device,
                                        devices=devices)
    else:
        _micro_batching(vectorstore, dm_cfg)
    data_manager = DataManager(
        data_path=data_path,
        catalog=catalog,
        vectorstore=vectorstore,
        sources_config=dm_cfg.get("sources", {}),
        chunk_size=dm_cfg.get("chunk_size", 1000),
        chunk_overlap=dm_cfg.get("chunk_overlap", 0),
        parallel_workers=dm_cfg.get("parallel_workers", 32),
    )

    scheduler = CronScheduler()
    schedules = dm_cfg.get("schedules") or {}
    if schedules:
        scheduler.set_config_loader(
            lambda: config_service.get(
                "data_manager.schedules", schedules) or schedules,
            lambda name, spec: (lambda **kw: data_manager.run_ingestion()),
        )
    byok_store = open_byok_store(os.path.join(data_path, "byok.db"))
    return ServiceContext(
        config=config,
        app_db=app_db,
        config_service=config_service,
        users=UserService(app_db),
        conversations=ConversationService(app_db),
        traces=TraceService(app_db),
        prompts=PromptService(app_db),
        catalog=catalog,
        vectorstore=vectorstore,
        data_manager=data_manager,
        scheduler=scheduler,
        byok_store=byok_store,
        byok_resolver=None if byok_store is None else BYOKResolver(
            byok_store),
    )
