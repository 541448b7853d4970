"""The port's MaxSim reranker (``archi_tpu_torch/engine/reranker.py``)
against the JAX package's ``archi_tpu/engine/reranker.py``.

``maxsim_scores`` on the same arrays (f32, atol 1e-5); ``MaxSimReranker``
through a small encoder (2 layers, H=64, the same weights drawn from seed 0
in both packages, f32): the same order and scores within 1e-4.  On the CPU
the port's encoder attention is its plain version and the JAX reranker runs
the XLA attention, both in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import reranker as jrr
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu.utils.documents import Document as JDoc
from archi_tpu_torch.engine.reranker import (MaxSimReranker,
                                             RerankingRetriever,
                                             maxsim_scores)
from archi_tpu_torch.models.bert import BertConfig
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
from archi_tpu_torch.utils.documents import Document

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position_embeddings=128)
WORDS = ("the quick brown fox batch scheduler storage quota gpu queue "
         "kernel tensor index search query latency memory shard").split()


@pytest.mark.parametrize("sq,sd,c", [(5, 9, 3), (32, 128, 7), (1, 1, 1)])
def test_maxsim_matches_jax(rng, sq, sd, c):
    h = 16
    q = rng.standard_normal((sq, h)).astype(np.float32)
    qm = (rng.random(sq) < 0.8).astype(np.float32)
    qm[0] = 1.0
    d = rng.standard_normal((c, sd, h)).astype(np.float32)
    dm = (rng.random((c, sd)) < 0.7).astype(np.float32)
    dm[:, 0] = 1.0
    d[0, :, :] = 0.0   # a zero candidate: tokens normalize by 1e-9
    want = np.asarray(jrr.maxsim_scores(q, qm, d, dm))
    got = maxsim_scores(*(torch.from_numpy(a) for a in (q, qm, d, dm)))
    assert got.dtype == torch.float32 and got.shape == (c,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def embedders():
    rng = np.random.default_rng(3)
    texts = [" ".join(rng.choice(WORDS, 12)) for _ in range(40)]
    jtok = JaxTokenizer.build_vocab(texts, size=CFG["vocab_size"])
    jemb = JaxEmbedder(config=JaxConfig(**CFG), tokenizer=jtok,
                       compute_dtype=jnp.float32, attention_impl="xla")
    temb = TorchEmbedder(config=BertConfig(**CFG),
                         tokenizer=WordPieceTokenizer(dict(jtok.vocab)),
                         device="cpu")
    return jemb, temb


def _docs(rng, n):
    return [" ".join(rng.choice(WORDS, rng.integers(3, 40)))
            for _ in range(n)]


@pytest.mark.parametrize("query", ["quick brown fox", "gpu kernel queue "
                                   "latency and memory of a shard", "zzz"])
def test_rerank_matches_jax(embedders, query):
    jemb, temb = embedders
    texts = _docs(np.random.default_rng(len(query)), 12)
    got = MaxSimReranker(temb).rerank(
        query, [(Document(t, {"i": i}), 0.5) for i, t in enumerate(texts)])
    want = jrr.MaxSimReranker(jemb).rerank(
        query, [(JDoc(t, {"i": i}), 0.5) for i, t in enumerate(texts)])
    gs, ws = [s for _, s in got], [s for _, s in want]
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    # the same order, up to scores tied within the tolerance
    for (gd, s), (wd, _) in zip(got, want):
        if gd.metadata["i"] != wd.metadata["i"]:
            assert sum(abs(x - s) <= 1e-4 for x in ws) > 1
    assert all(isinstance(s, float) for s in gs)
    assert got[0][1] >= got[-1][1]


def test_rerank_top_k_empty_and_long_documents(embedders):
    _, temb = embedders
    rr = MaxSimReranker(temb, max_query_tokens=8, max_doc_tokens=16)
    assert rr.rerank("q", []) == []
    long_doc = " ".join(WORDS * 20)             # cut to max_doc_tokens
    out = rr.rerank("fox", [(Document(long_doc), 0.1),
                            (Document("fox"), 0.2)], top_k=1)
    assert len(out) == 1 and out[0][0].page_content == "fox"
    assert rr.max_q == 8 and rr.max_d == 16


def test_reranking_retriever(embedders):
    _, temb = embedders

    class FakeBase:
        def invoke(self, q):
            return [(Document(f"doc {i} filler {WORDS[i]}"), 1.0 - i / 10)
                    for i in range(8)]

    rr = RerankingRetriever(FakeBase(), MaxSimReranker(temb), k=3)
    out = rr.invoke("filler doc")
    assert len(out) == 3 and out == rr("filler doc")
    assert rr.invoke("") is not None  # an empty query doesn't crash
