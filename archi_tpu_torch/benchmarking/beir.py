"""BEIR-format retrieval evaluation.

Counterpart of ``archi_tpu/benchmarking/beir.py``: the standard BEIR
directory layout (``corpus.jsonl``, ``queries.jsonl``, ``qrels/test.tsv``,
or an archive of it), ingest through ``TorchVectorStore``, and the standard
metrics (nDCG@10, recall@k, MRR@10), over a local dataset directory:

    archi-tpu-torch evaluate --beir /path/to/nfcorpus [--retriever-mode ...]

``write_fixture_beir`` writes a synthetic BEIR-format dataset, so the
loader and the metrics run end to end without a download.  The code is the
JAX package's, with one departure: ``evaluate_beir`` takes ``device=`` for
the store it builds.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional


_ARCHIVE_EXTS = (".tar.gz", ".tar.bz2", ".tar.xz", ".tgz", ".zip", ".tar")


def _dataset_name(path: str) -> str:
    """Dataset name from a directory or archive path: basename with the
    archive extension (and a prior ``_extracted`` unpack suffix) removed.
    Strips ONLY the archive extension: 'scifact.v1.zip' and
    'scifact.v2.zip' must not collide on one name."""
    stem = os.path.basename(path.rstrip("/")).removesuffix("_extracted")
    for ext in _ARCHIVE_EXTS:
        if stem.endswith(ext):
            return stem[:-len(ext)]
    return stem


def _extract_archive(path: str) -> str:
    """Unpack an official BEIR download (``nfcorpus.zip`` or ``.tar.gz``)
    next to itself and return the dataset directory inside it.

    The official archives wrap the layout in one top-level directory
    (``nfcorpus/corpus.jsonl`` ...); a flat archive (files at the root)
    also works.  Extraction is idempotent — an existing unpack is reused.
    """
    import tarfile
    import zipfile

    stem = _dataset_name(path)
    dest = os.path.join(
        os.path.dirname(os.path.abspath(path)), stem + "_extracted")
    if not os.path.isdir(dest):
        tmp = dest + ".tmp"
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                # refuse zip-slip members (absolute / parent-escaping)
                for name in z.namelist():
                    p = os.path.normpath(name)
                    if p.startswith(("/", "..")) or os.path.isabs(name):
                        raise ValueError(f"unsafe archive member: {name}")
                z.extractall(tmp)
        else:
            with tarfile.open(path) as t:
                # 'data' filter rejects path traversal, links out of the
                # tree, and devices (default from Python 3.14)
                t.extractall(tmp, filter="data")
        os.rename(tmp, dest)
    if os.path.isfile(os.path.join(dest, "corpus.jsonl")):
        return dest
    subdirs = [d for d in sorted(os.listdir(dest))
               if os.path.isdir(os.path.join(dest, d))]
    for d in subdirs:
        if os.path.isfile(os.path.join(dest, d, "corpus.jsonl")):
            return os.path.join(dest, d)
    raise FileNotFoundError(
        f"no corpus.jsonl found inside archive {path} (looked in root "
        f"and {subdirs})")


def load_beir(directory: str):
    """→ (corpus {did: text}, queries {qid: text}, qrels {qid: {did: rel}}).

    ``directory`` may also be an official BEIR ``.zip``/``.tar.gz``
    download, which is unpacked next to itself on first use.
    """
    if os.path.isfile(directory):
        directory = _extract_archive(directory)
    corpus = {}
    with open(os.path.join(directory, "corpus.jsonl"), encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            did = str(d.get("_id") or d.get("id"))
            title = d.get("title") or ""
            corpus[did] = f"{title}\n{d.get('text', '')}".strip()
    queries = {}
    with open(os.path.join(directory, "queries.jsonl"),
              encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            queries[str(d.get("_id") or d.get("id"))] = d.get("text", "")
    qrels: dict[str, dict[str, int]] = {}
    qrels_path = os.path.join(directory, "qrels", "test.tsv")
    if not os.path.isfile(qrels_path):
        qrels_path = os.path.join(directory, "qrels.tsv")
    with open(qrels_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.strip().split("\t")
            if not parts or (i == 0 and parts[-1].lower() in ("score",
                                                              "relevance")):
                continue  # header
            qid, did, rel = parts[0], parts[-2], parts[-1]
            if int(float(rel)) > 0:
                qrels.setdefault(str(qid), {})[str(did)] = int(float(rel))
    # only queries with judgments participate (BEIR convention)
    queries = {q: t for q, t in queries.items() if q in qrels}
    return corpus, queries, qrels


def ndcg_at_k(ranked: list[str], rels: dict[str, int], k: int) -> float:
    dcg = sum(
        (2 ** rels.get(d, 0) - 1) / math.log2(i + 2)
        for i, d in enumerate(ranked[:k])
    )
    ideal = sorted(rels.values(), reverse=True)[:k]
    idcg = sum((2 ** r - 1) / math.log2(i + 2) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(ranked: list[str], rels: dict[str, int], k: int) -> float:
    if not rels:
        return 0.0
    return len(set(ranked[:k]) & set(rels)) / len(rels)


def mrr_at_k(ranked: list[str], rels: dict[str, int], k: int) -> float:
    for i, d in enumerate(ranked[:k]):
        if d in rels:
            return 1.0 / (i + 1)
    return 0.0


def evaluate_beir(directory: str, *, embedder=None, mode: str = "hybrid",
                  k: int = 100, chunk_size: int = 0,
                  store=None, device=None) -> dict:
    """Ingest a BEIR dataset and score retrieval.

    embedder defaults to the deterministic hashed-ngram featurizer (no
    pretrained weights in this image); pass a `TorchEmbedder(model_dir=...)`
    for real-checkpoint runs.  chunk_size 0 = one chunk per document (BEIR
    docs are passage-sized); >0 splits and scores by best chunk per doc.
    device: where the store it builds lives (the card unless "cpu").
    """
    import numpy as np

    from archi_tpu_torch.data.chunking import character_split
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder

    corpus, queries, qrels = load_beir(directory)
    if store is None:
        store = TorchVectorStore(embedder or HashedNgramEmbedder(),
                                 device=device)
        texts, metas, ids = [], [], []
        for did, text in corpus.items():
            chunks = (character_split(text, chunk_size, 0)
                      if chunk_size else [text])
            for i, c in enumerate(chunks):
                texts.append(c)
                metas.append({"doc_id": did})
                ids.append(f"{did}#{i}")
        store.add_texts(texts, metas, ids=ids)

    weights = {"semantic": (1.0, 0.0), "bm25": (0.0, 1.0),
               "hybrid": (0.4, 0.6)}[mode]
    ndcgs, recs10, recs100, mrrs = [], [], [], []
    for qid, qtext in queries.items():
        results = store.hybrid_search(
            qtext, k=k, semantic_weight=weights[0], bm25_weight=weights[1])
        ranked, seen = [], set()
        for doc, _s in results:
            did = doc.metadata.get("doc_id")
            if did not in seen:
                seen.add(did)
                ranked.append(did)
        rels = qrels[qid]
        ndcgs.append(ndcg_at_k(ranked, rels, 10))
        recs10.append(recall_at_k(ranked, rels, 10))
        recs100.append(recall_at_k(ranked, rels, 100))
        mrrs.append(mrr_at_k(ranked, rels, 10))
    return {
        "dataset": _dataset_name(directory),
        "mode": mode,
        "documents": len(corpus),
        "queries": len(queries),
        "ndcg@10": round(float(np.mean(ndcgs)), 4),
        "recall@10": round(float(np.mean(recs10)), 4),
        "recall@100": round(float(np.mean(recs100)), 4),
        "mrr@10": round(float(np.mean(mrrs)), 4),
    }


def write_fixture_beir(directory: str, *, n_topics: int = 12,
                       docs_per_topic: int = 6, seed: int = 3) -> None:
    """Synthetic BEIR-format dataset: topical docs + judged queries with
    GRADED relevance (2 = exact topic+facet, 1 = same topic)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(directory, "qrels"), exist_ok=True)
    facets = ["overview", "setup", "errors", "limits", "api", "examples"]
    with open(os.path.join(directory, "corpus.jsonl"), "w") as f:
        for t in range(n_topics):
            for d in range(docs_per_topic):
                facet = facets[d % len(facets)]
                filler = " ".join(f"w{int(x)}" for x in
                                  rng.integers(0, 400, 25))
                f.write(json.dumps({
                    "_id": f"t{t}d{d}",
                    "title": f"topic{t} {facet} guide",
                    "text": f"all about topic{t} subject, focusing on "
                            f"{facet} details. {filler}",
                }) + "\n")
    with open(os.path.join(directory, "queries.jsonl"), "w") as f, \
            open(os.path.join(directory, "qrels", "test.tsv"), "w") as q:
        q.write("query-id\tcorpus-id\tscore\n")
        for t in range(n_topics):
            qid = f"q{t}"
            facet = facets[t % len(facets)]
            f.write(json.dumps({
                "_id": qid,
                "text": f"topic{t} {facet} information",
            }) + "\n")
            for d in range(docs_per_topic):
                rel = 2 if facets[d % len(facets)] == facet else 1
                q.write(f"{qid}\tt{t}d{d}\t{rel}\n")
