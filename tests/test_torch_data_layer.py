"""The port's data layer: catalog, persistence, chunking and the
``IndexManager`` diff sync over ``TorchVectorStore`` on the CPU.

The counterpart of ``tests/unit/test_data_layer.py`` (the same cases over
the port's modules and store), plus one parity case: the same corpus goes
through the JAX package's ``DataManager`` (``JaxEmbedder``) and the port's
(``TorchEmbedder``, the same weights through a local HF snapshot), and the
catalogs, the chunks and the hybrid rankings agree (scores within 1e-4,
tie-aware).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from archi_tpu.data.catalog import CatalogService as JaxCatalog
from archi_tpu.data.data_manager import DataManager as JaxDataManager
from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.bert import init_params
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu.models.train_encoder import save_model_dir
from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.chunking import (character_split,
                                           sliding_window_split)
from archi_tpu_torch.data.data_manager import DataManager
from archi_tpu_torch.data.data_viewer import DataViewerService
from archi_tpu_torch.data.manager import IndexManager
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata
from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.models.embedder import TorchEmbedder
from tests.unit.test_vectorstore import FakeEmbeddings


@pytest.fixture(scope="module", autouse=True)
def jax_cache_in_tmp(tmp_path_factory):
    """Keep JAX's compilation cache in this run's temporary directory for
    the module's span.  The JAX package's ``build_context`` points it at
    ``JAX_CACHE_DIR``, by default a fixed directory outside the checkout
    that every run on the host shares; the cache keeps the first directory
    it opens until it is reset."""
    before = jax.config.jax_compilation_cache_dir
    path = str(tmp_path_factory.mktemp("jax_cache"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_CACHE_DIR", path)
        compilation_cache.reset_cache()
        compilation_cache.set_cache_dir(path)
        yield path
    compilation_cache.reset_cache()
    compilation_cache.set_cache_dir(before)


def _store():
    return TorchVectorStore(FakeEmbeddings(), dtype=torch.float32,
                            device="cpu")


@pytest.fixture
def stack(tmp_path):
    catalog = CatalogService(str(tmp_path / "catalog.db"))
    persistence = PersistenceService(str(tmp_path / "data"), catalog)
    store = _store()
    manager = IndexManager(catalog, persistence, store, chunk_size=120,
                           batch_files=2)
    return catalog, persistence, store, manager


def _resource(text, name="doc", source="local_files"):
    return Resource(text, ResourceMetadata(display_name=name,
                                           source_type=source))


# ---------------------------------------------------------------- catalog
def test_catalog_upsert_and_status(stack):
    catalog, persistence, _store, _m = stack
    h = persistence.persist_resource(_resource("hello world", "a"))
    doc = catalog.get_document(h)
    assert doc["display_name"] == "a"
    assert doc["ingestion_status"] == "pending"
    catalog.update_ingestion_status(h, "embedding")
    catalog.update_ingestion_status(h, "failed", "boom")
    doc = catalog.get_document(h)
    assert doc["ingestion_status"] == "failed"
    assert doc["ingestion_error"] == "boom"
    assert catalog.retry_failed() == 1
    assert catalog.get_document(h)["ingestion_status"] == "pending"


def test_catalog_lists_and_search(stack):
    catalog, persistence, _s, _m = stack
    persistence.persist_resource(_resource("alpha text", "alpha.txt"))
    persistence.persist_resource(_resource("beta text", "beta.txt", "links"))
    assert set(catalog.list_documents_grouped()) == {"local_files", "links"}
    hits = catalog.search_documents("alpha")
    assert len(hits) == 1 and hits[0]["display_name"] == "alpha.txt"
    assert catalog.stats()["total"] == 2


def test_catalog_soft_delete_and_selection(stack):
    catalog, persistence, _s, _m = stack
    h1 = persistence.persist_resource(_resource("one", "1"))
    h2 = persistence.persist_resource(_resource("two", "2"))
    assert catalog.enabled_hashes("conv") is None  # no selection → all
    catalog.set_document_enabled("conv", h1, False)
    assert catalog.enabled_hashes("conv") == {h2}
    catalog.delete_resource(h1)
    assert catalog.all_hashes() == {h2}


def test_migration_state_checkpoint(stack):
    catalog, *_ = stack
    assert catalog.get_migration_state("job") is None
    catalog.set_migration_state("job", {"phase": 1, "last_id": 42})
    assert catalog.get_migration_state("job") == {"phase": 1, "last_id": 42}


# --------------------------------------------------------------- chunking
def test_character_split_sizes():
    text = "\n\n".join(f"para {i} " + "x" * 50 for i in range(10))
    chunks = character_split(text, chunk_size=120, chunk_overlap=0)
    assert all(len(c) <= 120 for c in chunks)
    assert "".join(c.replace("\n\n", "") for c in chunks).count("para 0") == 1


def test_character_split_overlap():
    text = "\n\n".join(f"p{i}" for i in range(20))
    chunks = character_split(text, chunk_size=20, chunk_overlap=8)
    assert len(chunks) > 1
    assert any(chunks[i].split("\n\n")[-1] in chunks[i + 1]
               for i in range(len(chunks) - 1))


def test_character_split_oversized_piece():
    chunks = character_split("y" * 5000, chunk_size=1000)
    assert all(len(c) <= 1000 for c in chunks)
    assert sum(len(c) for c in chunks) == 5000


def test_sliding_window():
    chunks = sliding_window_split("a" * 100, window=40, stride=30)
    assert chunks[0] == "a" * 40
    assert len(chunks) == 3


# ---------------------------------------------------------------- manager
def test_diff_sync_add_remove(stack):
    catalog, persistence, store, manager = stack
    h1 = persistence.persist_resource(
        _resource("the quick brown fox " * 20, "a"))
    h2 = persistence.persist_resource(
        _resource("vector search engines " * 20, "b"))
    res = manager.update_vectorstore()
    assert res["added"] == 2 and res["failed"] == 0
    assert store.count() > 2  # chunked
    assert catalog.get_document(h1)["ingestion_status"] == "embedded"
    res2 = manager.update_vectorstore()
    assert res2["added"] == 0 and res2["removed"] == 0
    persistence.delete_resource(h1)
    res3 = manager.update_vectorstore()
    assert res3["removed"] == 1
    assert manager.store_hashes() == {h2}


def test_per_file_isolation(stack, tmp_path):
    catalog, persistence, store, manager = stack
    good = persistence.persist_resource(_resource("good text " * 50, "good"))
    catalog.upsert_resource("badhash", display_name="bad",
                            file_path=str(tmp_path / "missing.xyz"))
    res = manager.update_vectorstore()
    assert res["added"] == 1 and res["failed"] == 1
    assert catalog.get_document(good)["ingestion_status"] == "embedded"
    bad = catalog.get_document("badhash")
    assert bad["ingestion_status"] == "failed"
    assert "parse" in bad["ingestion_error"]
    res2 = manager.update_vectorstore()
    assert res2["failed"] == 0 and res2["added"] == 0
    assert manager.retry_failed()["failed"] == 1


def test_embed_failure_isolated_per_file(stack, monkeypatch):
    catalog, persistence, store, manager = stack
    h1 = persistence.persist_resource(_resource("alpha " * 50, "a"))
    h2 = persistence.persist_resource(_resource("POISON " * 50, "b"))
    real_add = store.add_texts

    def flaky_add(texts, metadatas=None, ids=None, **kw):
        if any("POISON" in t for t in texts):
            raise RuntimeError("embed blew up")
        return real_add(texts, metadatas, ids=ids, **kw)

    monkeypatch.setattr(store, "add_texts", flaky_add)
    res = manager.update_vectorstore()
    assert res["added"] == 1 and res["failed"] == 1
    assert catalog.get_document(h1)["ingestion_status"] == "embedded"
    assert catalog.get_document(h2)["ingestion_status"] == "failed"


def test_resume_after_partial_ingest(stack):
    catalog, persistence, store, manager = stack
    for i in range(5):
        persistence.persist_resource(_resource(f"text {i} " * 30, f"d{i}"))
    manager.update_vectorstore()
    manager2 = IndexManager(catalog, persistence, store, chunk_size=120)
    res = manager2.update_vectorstore()
    assert res["added"] == 0 and res["removed"] == 0


def test_content_edit_is_remove_plus_add(stack):
    catalog, persistence, store, manager = stack
    h1 = persistence.persist_resource(
        _resource("version one content " * 20, "doc"))
    manager.update_vectorstore()
    h2 = persistence.persist_resource(
        _resource("version TWO content " * 20, "doc"))
    persistence.delete_resource(h1)
    res = manager.update_vectorstore()
    assert res["added"] == 1 and res["removed"] == 1
    assert manager.store_hashes() == {h2}


@pytest.mark.parametrize("workers", [1, 8])
def test_parallel_parse_pipeline_isolation_and_order(tmp_path, workers):
    """Parallel, pipelined parsing keeps per-file isolation and syncs every
    good file, at one worker too (the prefetch driver's own thread)."""
    catalog = CatalogService(str(tmp_path / "cat.db"))
    pers = PersistenceService(str(tmp_path / "data"), catalog)
    store = _store()
    mgr = IndexManager(catalog, pers, store, batch_files=4,
                       parallel_workers=workers)
    for i in range(11):
        meta = ResourceMetadata(display_name=f"d{i}.txt",
                                source_type="local_files", extension=".txt")
        pers.persist_resource(Resource(
            f"{workers} searchable content number {i}", meta))
    bad_hash = pers.persist_resource(Resource("  ", ResourceMetadata(
        display_name="bad.bin", source_type="local_files",
        extension=".bin")))
    result = mgr.update_vectorstore()
    assert result["added"] == 11 and result["failed"] == 1
    assert catalog.get_document(bad_hash)["ingestion_status"] == "failed"
    assert len([d for d in catalog.list_documents()
                if d["ingestion_status"] == "embedded"]) == 11
    assert store.hybrid_search(f"{workers} searchable number", k=3)


def test_viewer_lists_a_documents_chunks_and_stats(stack):
    catalog, persistence, store, manager = stack
    h = persistence.persist_resource(_resource("the quick brown fox " * 20))
    manager.update_vectorstore()
    viewer = DataViewerService(catalog, persistence, store)
    chunks = viewer.document_chunks(h)
    assert [c["chunk_id"] for c in chunks] == sorted(
        c for c in store.ids())
    assert viewer.document_detail(h)["content_length"] == 400
    stats = viewer.stats()
    assert stats["chunks"] == store.count() == len(chunks)
    # the dtype named as the JAX package names it
    assert stats["index_dtype"] == "float32"


# ------------------------------------------------ parity with the JAX stack
WORDS = ("slurm", "batch", "queue", "quota", "storage", "eos", "grafana",
         "dashboard", "xrootd", "transfer", "ticket", "wiki", "cluster",
         "node", "gpu", "partition", "account", "mail", "archive", "error")


def same_ranking(got, want, tol=1e-4):
    """Tie-aware: [(id, score)] lists of equal length, scores within tol,
    and ids that differ sit at the cut, tied within tol."""
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _i, s in got], [s for _i, s in want],
                               atol=tol)
    cut = min((s for _i, s in want), default=0.0)
    g, w = dict(got), dict(want)
    for cid in set(g) ^ set(w):
        assert abs(g.get(cid, w.get(cid)) - cut) <= tol, (cid, got, want)


@pytest.fixture(scope="module")
def twin_managers(tmp_path_factory):
    """One corpus of 24 files through the JAX and the port's DataManager,
    the same encoder weights (a local HF snapshot) under both."""
    tmp = tmp_path_factory.mktemp("twins")
    rng = np.random.default_rng(0)
    corpus = tmp / "corpus"
    corpus.mkdir()
    texts = []
    for i in range(24):
        paras = ["\n".join(" ".join(rng.choice(WORDS, 8)) for _ in range(3))
                 for _ in range(3)]
        texts.append("\n\n".join(paras))
        (corpus / f"doc{i:02d}.md").write_text(texts[-1])
    cfg = JaxConfig(vocab_size=200, hidden_size=64, num_layers=2,
                    num_heads=2, intermediate_size=128,
                    max_position_embeddings=128)
    model = str(tmp / "model")
    save_model_dir(model, cfg, init_params(cfg, seed=3),
                   JaxTokenizer.build_vocab(texts, size=200))
    sources = {"local_files": {"paths": [str(corpus)]}}
    jax_dm = JaxDataManager(
        data_path=str(tmp / "jax"), catalog=JaxCatalog(str(tmp / "j.db")),
        vectorstore=TpuVectorStore(JaxEmbedder(
            model_dir=model, compute_dtype=jnp.float32, attention_impl="xla",
            max_length=128), dtype=np.float32),
        sources_config=sources, chunk_size=200)
    port_dm = DataManager(
        data_path=str(tmp / "port"), catalog=CatalogService(str(tmp / "p.db")),
        vectorstore=TorchVectorStore(
            TorchEmbedder(model_dir=model, device="cpu", max_length=128),
            dtype=torch.float32, device="cpu"),
        sources_config=sources, chunk_size=200)
    results = (jax_dm.run_ingestion(), port_dm.run_ingestion())
    return jax_dm, port_dm, results


def test_ingest_matches_the_jax_data_manager(twin_managers):
    jax_dm, port_dm, (jax_res, port_res) = twin_managers
    keys = ("collected", "added", "removed", "failed", "total_chunks")
    assert {k: port_res[k] for k in keys} == {k: jax_res[k] for k in keys}
    assert port_res["added"] == 24 and port_res["total_chunks"] > 24

    def rows(dm):
        return sorted((d["resource_hash"], d["display_name"],
                       d["ingestion_status"], d["size_bytes"])
                      for d in dm.catalog.list_documents())

    assert rows(port_dm) == rows(jax_dm)
    ids = sorted(jax_dm.vectorstore.ids())
    assert sorted(port_dm.vectorstore.ids()) == ids
    assert [d.page_content for d in port_dm.vectorstore.get_by_ids(ids)] == \
        [d.page_content for d in jax_dm.vectorstore.get_by_ids(ids)]


@pytest.mark.parametrize("query", ["slurm batch queue", "storage quota eos",
                                   "gpu partition node error",
                                   "zzz unmatched words"])
def test_hybrid_ranking_matches_the_jax_data_manager(twin_managers, query):
    jax_dm, port_dm, _ = twin_managers

    def ranked(store):
        return [(d.metadata["chunk_id"], s)
                for d, s in store.hybrid_search(query, k=8)]

    same_ranking(ranked(port_dm.vectorstore), ranked(jax_dm.vectorstore))
