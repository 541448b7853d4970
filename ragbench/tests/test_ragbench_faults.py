"""The check catches a broken timed path: each fault a cell can have,
planted under a whole small run on the CPU (the look for a card skipped),
makes ``correct`` come out false, while the sound run is correct."""

import numpy as np
import pytest

from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from ragbench.tests._small import run_small, small_cell

#: the hybrid cell, and the same deployment behind the semantic retriever
RETRIEVERS = ["hybrid", "semantic"]


def _altered_answer(monkeypatch):
    """Each answer's best row replaced by the row after it."""
    orig = TorchVectorStore._rows_to_results

    def broken(self, rows, vals):
        rows = np.array(rows, copy=True)
        rows[0] = (rows[0] + 1) % max(len(self.index), 1)
        return orig(self, rows, vals)

    monkeypatch.setattr(TorchVectorStore, "_rows_to_results", broken)


def _half_batch(monkeypatch):
    """Only the first half of each micro-batch searched; the rest get
    the answers of the first half."""
    for name in ("hybrid_search_batch", "similarity_search_batch"):
        orig = getattr(TorchVectorStore, name)

        def broken(self, queries, *a, _orig=orig, **kw):
            queries = list(queries)
            half = max(1, len(queries) // 2)
            out = _orig(self, queries[:half], *a, **kw)
            return [out[i % half] for i in range(len(queries))]

        monkeypatch.setattr(TorchVectorStore, name, broken)


@pytest.mark.parametrize("retriever", RETRIEVERS)
@pytest.mark.parametrize("fault", [None, _altered_answer, _half_batch])
def test_query_faults(retriever, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    cell = small_cell("trec-covid.hybrid")
    cell.traffic["retriever"] = retriever
    res = run_small(cell, seconds=2.0)
    assert res["correct"] is (fault is None), res["checks"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(TorchVectorStore, "add_texts",
                        lambda self, texts, metadatas=None, ids=None,
                        embeddings=None: list(ids or []))


def _half_inserted(monkeypatch):
    orig = TorchVectorStore.add_texts

    def broken(self, texts, metadatas=None, ids=None, embeddings=None):
        texts, metadatas, ids = list(texts), list(metadatas), list(ids)
        half = max(1, len(texts) // 2)
        orig(self, texts[:half], metadatas[:half], ids=ids[:half])
        return ids

    monkeypatch.setattr(TorchVectorStore, "add_texts", broken)


def _altered_embedding(monkeypatch):
    """Each batch's chunks embedded in the wrong order (rotated by one)."""
    orig = TorchVectorStore.add_texts

    def broken(self, texts, metadatas=None, ids=None, embeddings=None):
        texts = list(texts)
        emb = self._embedding_function.encode_numpy(texts)
        return orig(self, texts, metadatas, ids=ids,
                    embeddings=np.roll(emb, 1, axis=0))

    monkeypatch.setattr(TorchVectorStore, "add_texts", broken)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_inserted,
                                   _altered_embedding])
def test_ingest_faults(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    res = run_small(small_cell("trec-covid.ingest"), seconds=0.5)
    assert res["correct"] is (fault is None), res["checks"]
