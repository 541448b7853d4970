"""The plain reference against the port's CPU path at tiny sizes: the
reference must agree with a sound program before it can judge one."""

import numpy as np
import pytest
import torch

from ragbench import deploy, textgen, weights
from ragbench.reference import bert as ref_bert
from ragbench.reference.text import (BM25, WordPiece, analyze, bm25_dense,
                                     character_split)
from ragbench.tests._small import small_cell


@pytest.fixture(scope="module")
def corpus_and_config():
    cell = small_cell("trec-covid.hybrid")
    cfg = cell.config
    return deploy.corpus_module(cfg).Corpus(cfg, 99, "cpu"), cfg


def test_text_rules_match_the_port(corpus_and_config):
    from archi_tpu_torch.data.chunking import character_split as port_split
    from archi_tpu_torch.engine.bm25 import analyze as port_analyze
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

    corpus, _ = corpus_and_config
    tok = WordPieceTokenizer(dict(corpus.wp_vocab))
    ref_tok = WordPiece(corpus.wp_vocab)
    extra = ["Hello, World! it's 42 o'clock", "a-b c.d  e\n\nf", ""]
    for doc in corpus.documents[:200] + extra:
        assert character_split(doc) == port_split(doc)
        assert character_split(doc, 300, 120) == port_split(doc, 300, 120)
        assert analyze(doc) == port_analyze(doc)
        assert ref_tok.encode(doc, 256) == tok.encode(doc, 256)


def test_bm25_matches_the_port(corpus_and_config):
    from archi_tpu_torch.engine.bm25 import BM25Index

    corpus, _ = corpus_and_config
    texts = corpus.texts
    queries = corpus.queries(40, 0.1)
    idx = BM25Index(device="cpu")
    idx.add(list(range(len(texts))), texts)
    port = torch.stack([idx.scores(q, len(texts)) for q in queries]).double()
    dense = bm25_dense(texts, queries, "cpu")
    assert torch.allclose(dense, port, rtol=1e-5, atol=1e-5)
    # the loop version agrees with the tensor version exactly
    slow = BM25(texts, {t for q in queries for t in analyze(q)})
    for i, q in enumerate(queries):
        for row, v in slow.scores(q).items():
            assert dense[i, row].item() == pytest.approx(v, rel=1e-12)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encoder_matches_the_port(corpus_and_config, pooling):
    corpus, cfg = corpus_and_config
    cfg = {**cfg, "encoder": {**cfg["encoder"], "pooling": pooling}}
    w = weights.encoder_weights(cfg["encoder"], 5, "cpu")
    emb = deploy.embedder(cfg, w, corpus.wp_vocab, "cpu")
    texts = corpus.texts[:16] + corpus.queries(16, 0.0)
    port = torch.from_numpy(emb.encode_numpy(texts))
    tok = WordPiece(corpus.wp_vocab)
    ref = ref_bert.encode_texts(
        w, [tok.encode(t, 256) for t in texts], device="cpu",
        num_layers=cfg["encoder"]["num_hidden_layers"],
        num_heads=cfg["encoder"]["num_attention_heads"],
        pooling=pooling)
    assert float((1 - (port * ref).sum(1)).max()) < 1e-5


def test_fp8_control_is_coarser():
    x = torch.randn(64, 64)
    err = (ref_bert.fp8_round(x) - x).abs().max() / x.abs().max()
    assert 1e-3 < float(err) < 0.07


def test_rows_repeat_by_block():
    a = weights.index_rows(11, 0, 3000, 16, "cpu", 1024)
    b = weights.index_rows(11, 1500, 1000, 16, "cpu", 1024)
    assert torch.equal(a[1500:2500], b)
    assert a.dtype == torch.bfloat16


def test_wordpiece_vocab_is_dense_and_sized():
    vocab = textgen.make_vocab(textgen.rng_for(1, "vocab"), 40000)
    wp = textgen.wordpiece_vocab(vocab, 30522)
    assert len(wp) == 30522
    assert sorted(wp.values()) == list(range(30522))
    assert np.all([wp[s] == i for i, s in enumerate(textgen.SPECIALS)])
