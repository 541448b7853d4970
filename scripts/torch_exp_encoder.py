#!/usr/bin/env python3
"""Encoder-recipe experiment loop on the PyTorch/CUDA port.

Counterpart of ``scripts/exp_encoder.py``, with its flags and result keys.
Trains one encoder variant on the fixture corpus on the card (the strict
query-side holdout of the eval alias half, as ``torch_run_quality.py``) and
scores the hybrid and semantic-only hit@5 of the main, hard and synonym
query families without the QA pipeline, so a recipe costs one training run.
``--hash-only`` scores the hashed-ngram featurizer instead.  Each run prints
one JSON line and appends it to the experiments log.

Paths, as in the JAX script: the log ``/tmp/enc_experiments.jsonl`` and the
snapshot ``/tmp/enc_exp_<tag>`` (under the temporary directory of the
machine); ``run()`` takes both as arguments.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_exp_encoder.py TAG [--steps N] [--hidden N]
        [--layers N] [training flags as in torch_run_quality.py]
        [--hash-only] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

DEFAULT_LOG = os.path.join(tempfile.gettempdir(), "enc_experiments.jsonl")


def ablate(store, queries, k=5, modes=("hybrid", "semantic_only")):
    weights = {"hybrid": dict(semantic_weight=0.4, bm25_weight=0.6),
               "semantic_only": dict(semantic_weight=1.0, bm25_weight=0.0),
               "bm25_only": dict(semantic_weight=0.0, bm25_weight=1.0)}
    out = {}
    for name in modes:
        hits = 0
        for q in queries:
            expected = {next(iter(s.values()))
                        for s in q["reference_sources"]}
            res = store.hybrid_search(q["question"], k=k, **weights[name])
            if expected & {d.metadata.get("source") for d, _s in res}:
                hits += 1
        out[name] = round(hits / len(queries), 4)
    return out


def score_store(embedder, *, device) -> dict:
    """The three query families' ablations over the fixture's chunks."""
    from archi_tpu_torch.benchmarking.fixture import (fixture_corpus,
                                                      fixture_hard_queries,
                                                      fixture_synonym_queries)
    from scripts.torch_run_quality import build_store

    store, _n = build_store(embedder, device=device)
    return {"main": ablate(store, fixture_corpus()[1]),
            "hard": ablate(store, fixture_hard_queries()),
            "synonym": ablate(store, fixture_synonym_queries())}


def run(tag: str = "exp", *, hash_only: bool = False, train_kw=None,
        log_path: str | None = DEFAULT_LOG, model_dir: str | None = None,
        device=None, log=print, losses=None) -> dict:
    """One experiment → its result line, appended to ``log_path`` (when
    given).  ``model_dir``: the snapshot (default ``enc_exp_<tag>`` under
    the temporary directory); ``losses``: a list that receives each step's
    loss; ``device``: the card unless ``"cpu"``."""
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    if hash_only:
        from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder

        res = {"tag": "hash", **score_store(HashedNgramEmbedder(),
                                            device=dev)}
    else:
        from archi_tpu_torch.models.embedder import TorchEmbedder
        from archi_tpu_torch.models.train_encoder import (save_model_dir,
                                                          train)
        from scripts.torch_run_quality import fixture_chunks, held_out_words

        train_kw = dict(train_kw or {"batch": 128, "seq_len": 96, "seed": 0,
                                     "steps": 1500})
        texts, _metas, _ids = fixture_chunks()
        t0 = time.time()
        cfg, model, tok = train(texts, exclude_query_terms=held_out_words(),
                                log=log, device=dev, losses=losses,
                                **train_kw)
        train_s = time.time() - t0
        model_dir = model_dir or os.path.join(tempfile.gettempdir(),
                                              f"enc_exp_{tag}")
        save_model_dir(model_dir, cfg, model, tok)
        emb = TorchEmbedder(model_dir=model_dir, max_length=128, device=dev)
        res = {"tag": tag, "train_kw": train_kw,
               "train_s": round(train_s, 1), **score_store(emb, device=dev)}
    res["device"] = str(dev)
    log(json.dumps(res))
    if log_path:
        with open(log_path, "a") as f:
            f.write(json.dumps(res) + "\n")
    return res


def main() -> None:
    from scripts.torch_run_quality import train_kwargs

    args = sys.argv[1:]
    tag = args[0] if args and not args[0].startswith("-") else "exp"
    kw = train_kwargs(args, {"batch": 128, "seq_len": 96, "seed": 0,
                             "steps": 1500})
    if "--steps" in args:
        kw["steps"] = int(args[args.index("--steps") + 1])
    device = args[args.index("--device") + 1] if "--device" in args else None
    run(tag, hash_only="--hash-only" in args, train_kw=kw, device=device,
        log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
