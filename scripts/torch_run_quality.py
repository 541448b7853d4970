#!/usr/bin/env python3
"""Retrieval-quality run on the PyTorch/CUDA port.

Counterpart of ``scripts/run_quality.py``, with its flags, protocol and
payload keys.  End to end over the real pipeline: the fixture corpus
(``benchmarking/fixture.py``) → chunks (1000/0) → embed → the card's vector
and BM25 indexes → hybrid retrieval (k=5, bm25 0.6 / semantic 0.4) →
``QAPipeline`` → SOURCES accuracy, recall@10 against an exact scan, and
query QPS (``benchmarking/harness.Benchmarker``), plus three hit@5
ablations (hybrid, semantic only, BM25 only) over the main, the hard and
the synonym query families.

Two embedder sections:
- ``hash``: the deterministic hashed-ngram featurizer;
- ``trained``: a WordPiece + BERT encoder contrastively trained on the card
  by ``models/train_encoder.train`` over the fixture's chunks (document
  texts only; the eval half of the alias split is excluded from the query
  side of every training pair), saved as an HF snapshot and served through
  ``TorchEmbedder``.

Departure from the JAX script: its default output is ``QUALITY_r05.json``
in the repository and its ``Benchmarker`` writes ``./benchmark_results``;
here the payload goes to ``QUALITY_torch.json`` and the harness's files to
``quality_results/``, both under the temporary directory, unless
``out.json`` / ``--out-dir`` name others.  The trained snapshot's default
directory is the JAX script's name under the temporary directory.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_run_quality.py [out.json] [--encoder hash|trained|both]
        [--model-dir DIR] [--steps N] [--batch N] [--pooling mean|cls|attn]
        [--hard-neg F] [--splice-mined F] [--mid-views N] [--n-views N]
        [--seq-len N] [--lr F] [--tau F] [--hidden N] [--layers N]
        [--seed N] [--out-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "QUALITY_torch.json")
DEFAULT_RESULTS = os.path.join(tempfile.gettempdir(), "quality_results")
DEFAULT_MODEL_DIR = os.path.join(tempfile.gettempdir(),
                                 "archi_trained_encoder")
#: the JAX script's training knobs: flag → (train keyword, type)
TRAIN_FLAGS = (("--batch", "batch", int),
               ("--pooling", "pooling", str),
               ("--hard-neg", "hard_neg_frac", float),
               ("--splice-mined", "splice_mined", float),
               ("--mid-views", "mid_views", int),
               ("--n-views", "n_views", int),
               ("--seq-len", "seq_len", int),
               ("--lr", "lr", float),
               ("--tau", "tau", float),
               ("--hidden", "hidden", int),
               ("--layers", "layers", int),
               ("--seed", "seed", int))


def train_kwargs(args, base: dict) -> dict:
    """``base`` updated with every training flag present in ``args``."""
    out = dict(base)
    for flag, key, cast in TRAIN_FLAGS:
        if flag in args:
            out[key] = cast(args[args.index(flag) + 1])
    return out


def fixture_chunks():
    from archi_tpu_torch.benchmarking.fixture import fixture_corpus
    from archi_tpu_torch.data.chunking import character_split

    docs, _ = fixture_corpus()
    texts, metas, ids = [], [], []
    for name, text, meta in docs:
        for i, chunk in enumerate(character_split(text, chunk_size=1000,
                                                  chunk_overlap=0)):
            texts.append(chunk)
            metas.append(dict(meta))
            ids.append(f"{name}:{i}")
    return texts, metas, ids


def build_store(embedder, *, device):
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore

    texts, metas, ids = fixture_chunks()
    store = TorchVectorStore(embedder, device=device)
    store.add_texts(texts, metas, ids=ids)
    return store, len(texts)


def retriever_ablation(store, queries, k: int = 5) -> dict:
    """Hit@k of the expected source under each retrieval mode."""
    modes = {
        "hybrid": dict(semantic_weight=0.4, bm25_weight=0.6),
        "semantic_only": dict(semantic_weight=1.0, bm25_weight=0.0),
        "bm25_only": dict(semantic_weight=0.0, bm25_weight=1.0),
    }
    out = {}
    for name, w in modes.items():
        hits = 0
        for q in queries:
            expected = {next(iter(s.values())) for s in q["reference_sources"]}
            res = store.hybrid_search(q["question"], k=k, **w)
            got = {d.metadata.get("source") for d, _s in res}
            hits += bool(expected & got)
        out[f"{name}_hit@{k}"] = round(hits / len(queries), 4)
    return out


def run_section(embedder, embedder_desc: str, *, out_dir: str = DEFAULT_RESULTS,
                device=None) -> dict:
    from archi_tpu_torch.benchmarking.fixture import (fixture_corpus,
                                                      fixture_hard_queries,
                                                      fixture_synonym_queries)
    from archi_tpu_torch.benchmarking.harness import Benchmarker
    from archi_tpu_torch.orchestrator.archi import Archi

    t0 = time.time()
    store, n_chunks = build_store(embedder, device=device)
    _docs, queries = fixture_corpus()
    archi = Archi("QAPipeline", vectorstore=store)
    bench = Benchmarker(
        archi, queries, modes=("SOURCES", "RETRIEVAL"),
        out_dir=out_dir, vectorstore=store, retrieval_k=10,
    )
    report = bench.run()
    totals = report["totals"]
    return {
        "embedder": embedder_desc,
        "chunks": n_chunks,
        "source_accuracy": totals.get("source_accuracy"),
        "relative_source_accuracy": totals.get("relative_source_accuracy"),
        "recall_at_10": totals.get("recall_at_k"),
        "query_qps": totals.get("query_qps"),
        "retriever_ablation": retriever_ablation(store, queries),
        "hard_query_ablation": retriever_ablation(
            store, fixture_hard_queries()),
        "synonym_query_ablation": retriever_ablation(
            store, fixture_synonym_queries()),
        "n_questions": totals["n_questions"],
        "avg_time_per_question_s": totals["avg_time_elapsed"],
        "wall_s": round(time.time() - t0, 1),
    }


def held_out_words() -> set[str]:
    """The words of the eval half of the alias split (query-side-excluded
    from every training pair)."""
    from archi_tpu_torch.benchmarking.fixture import fixture_alias_split

    _trainable, held_out = fixture_alias_split()
    return {w for alias in held_out for w in alias.split()}


def trained_embedder(model_dir: str, steps: int, train_kw: dict, *,
                     device=None, log=print, losses=None):
    """Load the trained snapshot, or train + save it first."""
    from archi_tpu_torch.models.embedder import TorchEmbedder

    if not os.path.isdir(model_dir):
        from archi_tpu_torch.models.train_encoder import (save_model_dir,
                                                          train)

        texts, _m, _i = fixture_chunks()
        held_words = held_out_words()
        log(f"training encoder on {len(texts)} fixture chunks ({steps} "
            f"steps, self-supervised ICT views — eval queries never seen; "
            f"{len(held_words)} held-out alias words query-side-excluded; "
            f"{train_kw})...")
        t0 = time.time()
        cfg, model, tok = train(texts, steps=steps,
                                exclude_query_terms=held_words, log=log,
                                device=device, losses=losses, **train_kw)
        log(f"trained in {time.time() - t0:.0f}s")
        save_model_dir(model_dir, cfg, model, tok)
    return TorchEmbedder(model_dir=model_dir, max_length=128, device=device)


def run(out_path=DEFAULT_OUT, *, encoder: str = "both",
        model_dir: str = DEFAULT_MODEL_DIR, steps: int = 1500,
        train_kw: dict | None = None, out_dir: str = DEFAULT_RESULTS,
        device=None, log=print, losses=None) -> dict:
    """The JAX script's sections → its payload, written to ``out_path``
    (when given).  ``losses``: a list that receives each training step's
    loss; ``device``: the card unless ``"cpu"``."""
    from archi_tpu_torch.benchmarking.fixture import fixture_corpus
    from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    train_kw = train_kw or {"batch": 128, "seq_len": 96, "seed": 0}
    payload = {
        "fixture": {
            "corpus": "deterministic 40-topic support corpus "
                      "(archi_tpu_torch/benchmarking/fixture.py, seed 7)",
            "documents": len(fixture_corpus()[0]),
            "retriever": "hybrid k=5, bm25 0.6 / semantic 0.4",
        },
        "held_out_protocol": (
            "training supervision = document texts only (ICT views + "
            "corpus-mined acronym/definition/alias/salient-term pairs + "
            "noise-token splicing; models/train_encoder.py). Eval "
            "queries = the fixture's frozen question templates plus the "
            "hard-query template family ('problem with {t2} and {t3} "
            "setup') — a disjoint template family whose phrasings appear "
            "nowhere in the corpus or miners."),
        "synonym_protocol": (
            "every topic's main term has an invented two-word alias "
            "defined ONLY in the overview doc ('X, also known as Y'); "
            "synonym queries use the alias + one mid-rank term and target "
            "the TROUBLESHOOTING doc, which contains zero alias "
            "vocabulary. Aliases are split 50/50 (fixture_alias_split): "
            "the eval half is query-side-excluded from ALL training pairs "
            "(mined AND ICT views), so the mapping can only be absorbed "
            "from the defining sentence as document text. The hashed "
            "featurizer's only lexical path is the overview doc, which "
            "does not count as a hit."),
        "device": str(dev),
    }
    if encoder in ("hash", "both"):
        payload["hash"] = run_section(
            HashedNgramEmbedder(),
            "hashed-ngram featurizer (baseline ablation)",
            out_dir=out_dir, device=dev)
        log(json.dumps(payload["hash"], indent=2))
    if encoder in ("trained", "both"):
        payload["trained"] = run_section(
            trained_embedder(model_dir, steps, train_kw, device=dev,
                             log=log, losses=losses),
            f"WordPiece+BERT bi-encoder contrastively trained on {dev} "
            f"(models/train_encoder.py; ICT views + corpus-mined paraphrase "
            f"pairs + noise-token splicing, eval queries unseen), served "
            f"via TorchEmbedder from an HF-format snapshot",
            out_dir=out_dir, device=dev)
        log(json.dumps(payload["trained"], indent=2))
        # headline = the real-encoder path
        payload["source_accuracy"] = payload["trained"]["source_accuracy"]
        payload["recall_at_10"] = payload["trained"]["recall_at_10"]
    elif "hash" in payload:
        payload["source_accuracy"] = payload["hash"]["source_accuracy"]
        payload["recall_at_10"] = payload["hash"]["recall_at_10"]
    if out_path:
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
    return payload


def main() -> None:
    args = sys.argv[1:]
    out_path = args[0] if args and not args[0].startswith("-") \
        else DEFAULT_OUT

    def opt(flag, default, cast=str):
        return cast(args[args.index(flag) + 1]) if flag in args else default

    payload = run(
        out_path, encoder=opt("--encoder", "both"),
        model_dir=opt("--model-dir", DEFAULT_MODEL_DIR),
        steps=opt("--steps", 1500, int),
        train_kw=train_kwargs(args, {"batch": 128, "seq_len": 96,
                                     "seed": 0}),
        out_dir=opt("--out-dir", DEFAULT_RESULTS),
        device=opt("--device", None), log=lambda m: print(m, flush=True))
    print(json.dumps(payload, indent=2))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
