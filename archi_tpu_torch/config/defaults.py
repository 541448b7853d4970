"""Default configuration — the ``base-config.yaml`` analog.

Copy of ``archi_tpu/config/defaults.py``.

Mirrors the reference's 250-line Jinja config schema
(``src/cli/templates/base-config.yaml``): the full option surface for
services, the data manager (embedding map, chunking, retriever weights,
sources), pipelines, and providers — here as a plain dict merged under user
YAML overrides.  Static vs dynamic split follows ``init.sql:95-176``:
static = immutable at runtime (embedding model/dims, chunking, paths);
dynamic = runtime-mutable (active model/pipeline, temperature, k/weights,
schedules, verbosity).
"""

from __future__ import annotations

import copy

DEFAULT_CONFIG: dict = {
    "name": "archi-tpu",
    "services": {
        "chat": {"enabled": True, "host": "0.0.0.0", "port": 7861},
        # Loopback by default: the data app has no per-user auth of its own
        # (the chat app proxies to it and enforces RBAC there), so binding
        # 0.0.0.0 would bypass DATA_UPLOAD/DATA_DELETE entirely.  Set
        # ``host: 0.0.0.0`` + DATA_MANAGER_TOKEN to expose it across hosts.
        "data_manager": {"enabled": True, "host": "127.0.0.1", "port": 7862},
        # roster_file (email,access_code CSV) + data_path (rubric_<n>.txt,
        # welcome/thankyou messages) + GRADER_ADMIN_PASSWORD secret mount
        # the student/admin web UI (web/grader_ui.py) on the same port
        "grader": {"enabled": False, "port": 7863, "roster_file": None,
                   "data_path": None, "total_problems": None},
        "piazza": {"enabled": False},
        "mattermost": {"enabled": False},
        "redmine_mailer": {"enabled": False},
        "benchmarking": {"enabled": False},
        "grafana": {"enabled": False, "port": 3000},
    },
    "data_manager": {
        "embedding_name": "jax",
        "embedding_kwargs": {"model_dir": None, "max_length": 256},
        "embedding_dimensions": 384,
        "chunk_size": 1000,
        "chunk_overlap": 0,
        "stemming": {"enabled": False},
        "parallel_workers": 32,
        "data_path": "./archi_data",
        "db_path": "./archi_data/catalog.db",
        "index": {
            # flat | sharded (device-mesh corpus) | ivf (ANN serving:
            # IVF snapshot + exact fresh-row tail)
            "type": "flat",
            "dtype": "bfloat16",
            "tile_n": 4096,
            "nlist": 1024,           # ivf cells
            "nprobe": 64,
            # ivfpq only: probe by per-block mini-centroid budget instead
            # of whole cells (exact work = nprobe_blocks * block rows)
            "nprobe_blocks": None,
            # optional two-level gate for block-budget probing: only
            # blocks owned by the query's top-`cell_gate` cells compete
            # in the block ranking (shrinks mini-centroid noise field)
            "cell_gate": None,
            # sub-block ranking: a block ranks by the MAX of this many
            # finer mini-centroids (resolves multi-modal blocks; 8 at
            # block=512 = 64-row granularity)
            "block_rank_sub": 8,
            # hot-tail segmented appends for heavy streaming ingest
            # (O(tail) copies instead of O(corpus); docs/streaming_ingest.md)
            "hot_tail": False,
            "merge_rows": 65536,
        },
        "serving": {
            # coalesce concurrent hybrid queries into fused device batches
            # (engine/batcher.py); bounded added latency (max_wait_ms),
            # multiplicative throughput under load
            "micro_batch": {
                "enabled": False,
                "max_batch": 32,
                "max_wait_ms": 4.0,
                "workers": 2,   # batches in flight (pipelines device RTT)
            },
        },
        "retrievers": {
            "hybrid_retriever": {
                "num_documents_to_retrieve": 5,
                "bm25_weight": 0.6,
                "semantic_weight": 0.4,
            },
            "semantic_retriever": {"num_documents_to_retrieve": 5},
        },
        "sources": {
            "local_files": {"paths": []},
            "links": [],
            "git": {"repos": []},
            "tickets": {"jira": [], "redmine": []},
        },
        "schedules": {},
    },
    "pipelines": {
        "QAPipeline": {
            "max_tokens": 7000,
            "models": {
                "condense_model": "local/echo",
                "chat_model": "local/echo",
            },
            "prompts": {},
        },
        "GradingPipeline": {"max_tokens": 7000, "models": {}, "prompts": {}},
        "ImageProcessingPipeline": {"models": {}, "prompts": {}},
        "BaseReActAgent": {
            "models": {"agent_model": "local/echo"},
            "recursion_limit": 50,
        },
        "CMSCompOpsAgent": {
            "models": {"agent_model": "local/echo"},
            "recursion_limit": 50,
        },
    },
    "active_pipeline": "QAPipeline",
    "providers": {
        "local": {"enabled": True, "mode": "echo"},
        "openai": {"enabled": True},
        "anthropic": {"enabled": True},
        "gemini": {"enabled": True},
        "openrouter": {"enabled": True},
    },
    "chat": {
        "temperature": 0.7,
        "num_responses_until_feedback": 3,
        "source_score_threshold": 0.0,
    },
    "verbosity": 3,
}

#: dotted paths that are immutable at runtime (static config).
STATIC_PATHS = (
    "data_manager.embedding_name",
    "data_manager.embedding_kwargs",
    "data_manager.embedding_dimensions",
    "data_manager.chunk_size",
    "data_manager.chunk_overlap",
    "data_manager.data_path",
    "data_manager.db_path",
    "data_manager.index",
    "services",
    "name",
)

#: required fields per enabled service (reference config_manager validation).
REQUIRED_FIELDS = {
    "chat": ["services.chat.port"],
    "data_manager": ["services.data_manager.port",
                     "data_manager.embedding_name"],
    "grader": ["services.grader.port"],
}


def default_config() -> dict:
    return copy.deepcopy(DEFAULT_CONFIG)
