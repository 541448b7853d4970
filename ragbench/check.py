"""The comparisons that decide ``correct``: what the program answered, or
what it stored, against the plain reference over the same inputs.

Each reading is a number with a limit (``checks`` in the result line).  The
reference runs after the window, in float32 with TF32 off; with
``control=True`` the same readings are also taken of the reference computed
in float8 (``reference/bert.py``), which has to fail them.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ragbench.reference import bert as ref_bert
from ragbench.reference.text import (WordPiece, analyze, bm25_dense,
                                     character_split)

NEG = float("-inf")


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows rounded to e4m3, each under its own scale (amax / 448)."""
    scale = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-30) / ref_bert.E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _encoder_args(config: dict) -> dict:
    e = config["encoder"]
    return {"num_layers": e["num_hidden_layers"],
            "num_heads": e["num_attention_heads"], "pooling": e["pooling"]}


def _tokens(texts, wp_vocab: dict, config: dict) -> list[list[int]]:
    tok = WordPiece(wp_vocab)
    n = config["encoder"]["max_length"]
    return [tok.encode(t, n) for t in texts]


def token_lengths(wp_vocab: dict, config: dict):
    """texts → the encoder's token count of each (the reference's
    WordPiece, [CLS] and [SEP] included, cut at max_length)."""
    return lambda texts: [len(t) for t in _tokens(texts, wp_vocab, config)]


def reference_scores(corpus, config: dict, kind: str, weights: dict,
                     queries: list[str], device, precision: str,
                     want_rows=None, lexical=None):
    """The retriever's scores of every row for each query, computed block by
    block: returns (top-k values [S, k], top-k rows [S, k], the scores at
    ``want_rows`` [S, m] or None).  Hybrid: w_sem · cos + w_bm25 · BM25,
    and cos alone where BM25 matches nothing, as archi's fallback does."""
    retr = config["archi"]["retrievers"][kind]
    k = retr["k"]
    q = ref_bert.encode_texts(weights, _tokens(queries, corpus.wp_vocab, config),
                              device=device, precision=precision,
                              **_encoder_args(config))
    s = len(queries)
    top_v = torch.full((s, k), NEG, dtype=torch.float64, device=device)
    top_r = torch.full((s, k), -1, dtype=torch.long, device=device)
    at = None
    if want_rows is not None:
        want = want_rows.to(device)
        at = torch.full(want.shape, NEG, dtype=torch.float64, device=device)
    for start, count in corpus.row_blocks():
        rows = torch.nn.functional.normalize(
            corpus.rows(start, count).float(), dim=1)
        if precision == "fp8":
            rows = _fp8_rows(rows)
        sc = (q @ rows.t()).double()
        if kind == "hybrid":
            dense, matched = lexical
            sc = torch.where(matched[:, None],
                             retr["semantic_weight"] * sc.double()
                             + retr["bm25_weight"] * dense[:, start:start + count],
                             sc.double())
        v, r = torch.topk(sc, min(k, count), dim=1)
        v = torch.cat([top_v, v], 1)
        r = torch.cat([top_r, r + start], 1)
        top_v, idx = torch.topk(v, k, dim=1)
        top_r = torch.gather(r, 1, idx)
        if at is not None:
            inside = (want >= start) & (want < start + count)
            local = (want - start).clamp(0, count - 1)
            at = torch.where(inside, torch.gather(sc, 1, local), at)
    return top_v, top_r, at


def lexical_side(corpus, queries: list[str], device):
    """Each query's BM25 score of every row, and whether it matched any."""
    dense = bm25_dense(corpus.texts, queries, device)
    return dense, dense.max(dim=1).values > 0


def _readings(answers, k: int, ref_kth, ref_at) -> dict:
    """answers: per query a list of (row, reported score); ref_at: the
    reference's scores at those rows (padded)."""
    gap = err = 0.0
    bad = 0
    for i, ans in enumerate(answers):
        rows = [r for r, _ in ans]
        if len(ans) != k or len(set(rows)) != len(rows) or min(
                rows, default=-1) < 0:
            bad += 1
            continue
        ref = ref_at[i, :len(ans)].double().cpu().numpy()
        rep = np.array([s for _, s in ans], np.float64)
        gap = max(gap, float(ref_kth[i]) - float(ref.min()))
        err = max(err, float(np.abs(rep - ref).max()))
    return {"bad_answers": bad, "rank_gap": max(gap, 0.0), "score_err": err}


def judge_queries(corpus, config: dict, kind: str, weights: dict,
                  queries: list[str], answers, device, *,
                  control: bool = False) -> dict:
    """Readings of the program's answers, and with ``control`` those of the
    reference in float8 in the program's place."""
    ref_bert.strict_float32()
    k = config["archi"]["retrievers"][kind]["k"]
    lexical = lexical_side(corpus, queries, device) if kind == "hybrid" else None
    want = torch.tensor([[r for r, _ in a][:k] + [0] * (k - len(a[:k]))
                         for a in answers], dtype=torch.long)
    top_v, _, at = reference_scores(corpus, config, kind, weights, queries,
                                    device, "float32", want, lexical)
    out = {"program": _readings(answers, k, top_v[:, -1], at)}
    if control:
        c_v, c_r, _ = reference_scores(corpus, config, kind, weights, queries,
                                       device, "fp8", None, lexical)
        _, _, c_at = reference_scores(corpus, config, kind, weights, queries,
                                      device, "float32", c_r, lexical)
        c_ans = [list(zip(r.tolist(), v.tolist()))
                 for r, v in zip(c_r.cpu(), c_v.cpu())]
        out["control"] = _readings(c_ans, k, top_v[:, -1], c_at)
    return out


def expected_chunks(config: dict, docs: list[str]) -> dict[str, str]:
    """Chunk id → text for the documents, by archi's rule: the SHA-256 of
    the file's bytes, then the chunk's number."""
    a = config["archi"]
    out = {}
    for doc in docs:
        h = hashlib.sha256(doc.encode()).hexdigest()
        for j, t in enumerate(character_split(doc, a["chunk_size"],
                                              a["chunk_overlap"])):
            out[f"{h}:{j}"] = t
    return out


def judge_ingest(config: dict, weights: dict, wp_vocab: dict,
                 expected: dict[str, str], stored: dict, sample: list[str],
                 device, *, control: bool = False) -> dict:
    """stored: what the program holds after the window: ``ids`` (every
    chunk id), ``texts`` (id → text), ``rows`` ([len(sample), H] float32,
    the stored rows of the sample), ``terms`` (sample id → (length,
    {term: tf}) of its BM25 postings), ``not_embedded`` (documents whose
    status is not ``embedded``)."""
    ref_bert.strict_float32()
    ids = set(stored["ids"])
    missing = len(ids ^ set(expected))
    text_bad = sum(1 for cid, t in stored["texts"].items()
                   if expected.get(cid) != t)
    lex_bad = 0
    for cid in sample:
        terms = analyze(expected[cid])
        counts: dict[str, int] = {}
        for t in terms:
            counts[t] = counts.get(t, 0) + 1
        if stored["terms"].get(cid) != (len(terms), counts):
            lex_bad += 1
    toks = _tokens([expected[c] for c in sample] or ["-"], wp_vocab, config)
    ref = ref_bert.encode_texts(weights, toks, device=device,
                                precision="float32", **_encoder_args(config))

    def emb_err(rows):
        if not len(sample):
            return 0.0
        rows = torch.nn.functional.normalize(rows.to(device).float(), dim=1)
        return float((1.0 - (rows * ref).sum(1)).max())

    base = {"missing_chunks": missing, "text_mismatch": text_bad,
            "lexical_mismatch": lex_bad,
            "not_embedded": stored["not_embedded"]}
    out = {"program": {**base, "emb_err": emb_err(stored["rows"])}}
    if control:
        c = ref_bert.encode_texts(weights, toks, device=device,
                                  precision="fp8", **_encoder_args(config))
        out["control"] = {**base, "emb_err": emb_err(_fp8_rows(c))}
    return out
