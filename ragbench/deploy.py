"""Builds a configuration's deployment of the program (``archi_tpu_torch``)
from the harness's inputs: the encoder with the seed's weights and the
corpus's WordPiece vocabulary, the micro-batched store, the retriever, and
for ingest the catalog, persistence and index manager.

This and the traffic modules are the only places that call the program.
"""

from __future__ import annotations

import os
from unittest import mock

import torch

from ragbench.spec import HERE, load_module


def corpus_module(config: dict):
    kind = config["corpus"]["kind"]
    return load_module(os.path.join(HERE, "corpora", f"{kind}.py"), kind)


def embedder(config: dict, weights: dict, wp_vocab: dict, device):
    """The program's embedder over the harness's weights (handed in where
    the program would load a checkpoint) and vocabulary."""
    from archi_tpu_torch.models import embedder as emb_mod
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

    e = config["encoder"]
    bert = BertConfig(
        vocab_size=e["vocab_size"], hidden_size=e["hidden_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"],
        intermediate_size=e["intermediate_size"],
        max_position_embeddings=e["max_position_embeddings"],
        type_vocab_size=e["type_vocab_size"],
        layer_norm_eps=e["layer_norm_eps"], pooling=e["pooling"])
    # the program's module names for the embedding tables
    state = {(k + ".weight" if k in ("word", "position", "token_type") else k):
             v for k, v in weights.items()}

    def load_or_init(model_dir, cfg, *, pooling, seed):
        return bert, state, None

    with mock.patch.object(emb_mod, "load_or_init", load_or_init):
        return emb_mod.TorchEmbedder(
            config=bert, tokenizer=WordPieceTokenizer(dict(wp_vocab)),
            device=device, max_length=e["max_length"], pooling=e["pooling"],
            compute_dtype=(torch.bfloat16 if torch.device(device).type == "cuda"
                           else torch.float32))


def store(config: dict, emb, device):
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore

    idx = config["index"]
    if idx["type"] != "flat":
        raise ValueError(f"index type {idx['type']!r} is not built here")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "int8": torch.int8}[idx["dtype"]]
    return TorchVectorStore(emb, dim=config["encoder"]["hidden_size"],
                            dtype=dtype, device=device)


def serve(config: dict, st) -> None:
    mb = config["archi"]["micro_batch"]
    st.enable_micro_batching(max_batch=mb["max_batch"],
                             max_wait_ms=mb["max_wait_ms"],
                             workers=mb["workers"])


def retriever(config: dict, kind: str, st):
    from archi_tpu_torch.retrievers.hybrid import HybridRetriever
    from archi_tpu_torch.retrievers.semantic import SemanticRetriever

    r = config["archi"]["retrievers"][kind]
    if kind == "hybrid":
        return HybridRetriever(st, k=r["k"], bm25_weight=r["bm25_weight"],
                               semantic_weight=r["semantic_weight"])
    if kind == "semantic":
        return SemanticRetriever(st, k=r["k"])
    raise ValueError(f"retriever {kind!r}")


def ingest_pipeline(config: dict, st, workdir: str):
    """Catalog (SQLite on disk), persistence (a data directory) and the
    index manager at the deployment's settings."""
    from archi_tpu_torch.data.catalog import CatalogService
    from archi_tpu_torch.data.manager import IndexManager
    from archi_tpu_torch.data.persistence import PersistenceService

    os.makedirs(workdir, exist_ok=True)
    catalog = CatalogService(os.path.join(workdir, "catalog.db"))
    persistence = PersistenceService(os.path.join(workdir, "data"), catalog)
    a = config["archi"]
    manager = IndexManager(catalog, persistence, st,
                           chunk_size=a["chunk_size"],
                           chunk_overlap=a["chunk_overlap"],
                           batch_files=a["batch_files"],
                           parallel_workers=a["parallel_workers"])
    return catalog, persistence, manager


def persist_document(persistence, text: str, name: str) -> str:
    """Register one document as a local file, as the local-files collector
    does; returns its resource hash."""
    from archi_tpu_torch.data.resource import Resource, ResourceMetadata

    meta = ResourceMetadata(display_name=name, source_type="local_files",
                            file_name=name, extension=".txt")
    return persistence.persist_resource(Resource(text.encode(), meta))
