#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's hybrid-retrieval main path on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each fails the run with a non-zero exit):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels of ``archi_tpu_torch/csrc`` from source;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives them (2^20 live rows of 384 in a 2^21-row
     index; MiniLM-L6's attention at the ingest and query buckets) and a
     few more, and time kernel, plain version and a one-call PyTorch
     yardstick;
  3. run the main path through ``TorchVectorStore`` over a MiniLM-L6
     ``TorchEmbedder`` at full width (random weights from a seed): ingest
     documents through the encoder, fill the index to 2^20 rows, run
     semantic and hybrid searches, check them against a brute-force scan of
     the same tensors, and check that both kernels' launch counters rose
     during that run while the top-k fallback counter stayed at 0;
  4. time the encoder and the query paths with CUDA events.

The last two lines are a JSON object listing the kernels and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

N_ROWS = 1 << 20           # flat-index rows (the flat tier's 1M x 384 scan)
N_DOCS = 4096              # documents ingested through the encoder
FILL_BATCH = 1 << 16
# the fill's last write (61,440 rows) reserves a 65,536-row write bucket,
# which takes the power-of-two capacity past 2^20
N_CAPACITY = 1 << 21
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
def topk_case(name, b, n_pad, n_active, dtype, per_query, k=10, d=384,
              timed=False):
    """Kernel vs plain top-k on one input; returns a result dict."""
    import torch

    from archi_tpu_torch.ops.topk import (NEG_INF, _scores, fused_topk,
                                          plain_topk, quantize_int8)

    g = torch.Generator(device="cuda").manual_seed(SEED + b)
    dev = torch.device("cuda")
    q = torch.nn.functional.normalize(
        torch.randn(b, d, device=dev, generator=g), dim=1)
    e = torch.nn.functional.normalize(
        torch.randn(n_pad, d, device=dev, generator=g), dim=1)
    e = quantize_int8(e) if dtype == torch.int8 else e.to(dtype)
    alive = torch.rand(n_pad, device=dev, generator=g) > 0.01
    bias = torch.where(alive, 0.0, NEG_INF)
    if per_query:
        bias = bias[None, :] + 0.3 * torch.rand(b, n_pad, device=dev,
                                                generator=g)
    vals, idx = fused_topk(q, e, bias, n_active, k=k)
    ref_vals, ref_idx = plain_topk(q, e, bias, n_active, k=k)
    torch.cuda.synchronize()
    check(vals.shape == (b, k) and bool(torch.isfinite(vals).all()),
          f"{name}: bad top-k values")
    err = float((vals - ref_vals).abs().max())
    col = torch.arange(n_pad, device=dev)
    scores = torch.where(col < n_active, _scores(q, e) + bias, NEG_INF)
    claimed = torch.gather(scores, 1, idx.long())
    row_err = float((claimed - vals).abs().max())
    del scores, claimed
    distinct = all(len(set(r)) == k for r in idx.cpu().tolist())
    if dtype == torch.int8:
        tol = 0.0   # integer products summed exactly: identical results
        check(torch.equal(idx, ref_idx), f"{name}: rows differ from plain")
    else:
        tol = 1e-4  # f32 sums in another order than the plain matmul
    check(err <= tol and row_err <= tol and distinct,
          f"{name}: max_abs_err {err:.3g} row_err {row_err:.3g} "
          f"distinct {distinct} (tol {tol})")
    res = {"case": name, "B": b, "n_pad": n_pad, "n_active": n_active,
           "dtype": str(dtype).replace("torch.", ""), "per_query_bias":
           per_query, "k": k, "max_abs_err": err, "tol": tol}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol}) ok")
    if timed:
        res["ms"] = cuda_ms(lambda: fused_topk(q, e, bias, n_active, k=k))
        res["plain_ms"] = cuda_ms(
            lambda: plain_topk(q, e, bias, n_active, k=k), iters=3, warmup=1)
        if dtype == torch.int8:
            # PyTorch has no public int8 x int8 -> int32 product on CUDA
            res["library_ms"] = None
        else:
            # the same function over the live rows (n_active >= k here)
            e_live, bias_live = e[:n_active], bias[..., :n_active]

            def library():
                s = (q.to(dtype) @ e_live.T).float() + bias_live
                return torch.topk(s, k, dim=1)
            res["library_ms"] = cuda_ms(library)
        # the function reads the live rows of E and of the bias only
        itemsize = e.element_size()
        bias_rows = b if per_query else 1
        nbytes = (n_active * d * itemsize + b * d * 4
                  + bias_rows * n_active * 4 + b * k * 8)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 2.0 * b * n_active * d, res["dtype"])
        log(f"    ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
            f"library {res['library_ms']} bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


def attention_case(name, b, s, dtype, nh=12, hd=32, timed=False):
    import torch
    import torch.nn.functional as F

    from archi_tpu_torch.ops.attention import encoder_attention, plain_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + s)
    dev = torch.device("cuda")
    h = nh * hd
    qkv = torch.randn(b, s, 3 * h, device=dev, generator=g).to(dtype)
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd) for i in range(3))
    lens = torch.randint(1, s + 1, (b,), device=dev, generator=g)
    lens[0] = 0                                   # a fully masked row
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).float()
    key_bias = (1.0 - mask) * -1e9
    scale = 1.0 / math.sqrt(hd)
    out = encoder_attention(q, k, v, key_bias, sm_scale=scale)
    ref = plain_attention(q, k, v, key_bias, sm_scale=scale)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        tol_desc, ok = "2e-5", err <= 2e-5
    else:   # one bf16 rounding step apart at most
        tol_desc = "2^-7*|ref| + 1e-3"
        ok = bool((diff <= ref.float().abs() * 2.0 ** -7 + 1e-3).all())
    check(ok, f"{name}: max_abs_err {err:.3g} (tol {tol_desc})")
    res = {"case": name, "B": b, "S": s, "nh": nh, "hd": hd,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": tol_desc}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol_desc}) ok")
    if timed:
        res["ms"] = cuda_ms(
            lambda: encoder_attention(q, k, v, key_bias, sm_scale=scale))
        res["plain_ms"] = cuda_ms(
            lambda: plain_attention(q, k, v, key_bias, sm_scale=scale),
            iters=3, warmup=1)
        mask_t = key_bias.to(dtype)[:, None, None, :]
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask_t, scale=scale))
        itemsize = q.element_size()
        nbytes = 4 * b * s * h * itemsize + b * s * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 4.0 * b * nh * s * s * hd, res["dtype"])
        log(f"    ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
            f"library {res['library_ms']:.4f} bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


# ------------------------------------------------------------------ phase 3
def synthetic_texts(rng, vocab, n, n_words, prefix=None):
    import numpy as np

    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    picks = rng.choice(len(vocab), size=(n, n_words), p=p)
    texts = [" ".join(vocab[j] for j in row) for row in picks]
    if prefix is not None:
        texts = [f"{prefix}{i:05d} {t}" for i, t in enumerate(texts)]
    return texts


def ids_of(results):
    return [d.metadata["chunk_id"] for d, _ in results]


def same_ranking(got, want, tol=1e-4):
    """Tie-aware: equal length, scores within tol, and any id mismatch sits
    between scores equal within tol."""
    if len(got) != len(want):
        return False
    for (gd, gs), (wd, ws) in zip(got, want):
        if abs(gs - ws) > tol:
            return False
    gs_by_id = {d.metadata["chunk_id"]: s for d, s in got}
    ws_by_id = {d.metadata["chunk_id"]: s for d, s in want}
    cut = min(s for _d, s in want) if want else 0.0
    for cid in set(gs_by_id) ^ set(ws_by_id):
        s = gs_by_id.get(cid, ws_by_id.get(cid))
        if abs(s - cut) > tol:
            return False
    return True


def brute_force_hybrid(store, queries, k, w_sem=0.7, w_b=0.3):
    """The batched hybrid ranking recomputed with the plain top-k over the
    store's own tensors (no kernel)."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.flat_index import l2_normalize
    from archi_tpu_torch.engine.topk import alive_to_bias
    from archi_tpu_torch.ops.topk import plain_topk

    index = store.index
    cap = index.capacity
    bm = torch.stack([store.bm25.scores(q, cap) for q in queries])
    embs = torch.from_numpy(store._embed_queries(queries)).cuda()
    bias = alive_to_bias(index.alive)[None, :] + bm * (w_b / w_sem)
    vals, rows = plain_topk(l2_normalize(embs), index.emb, bias,
                            index.n_rows, k=k)
    bm_max = bm.max(dim=1).values.cpu().numpy()
    out = []
    for b in range(len(queries)):
        res = store._rows_to_results(rows[b].cpu().numpy(),
                                     vals[b].cpu().numpy())
        scale = 1.0 if bm_max[b] <= 0.0 else w_sem
        out.append([(d, s * scale) for d, s in res])
    return out


def main_path(results: dict):
    """Phase 3: the port's main path at MiniLM-L6 width.  Returns the
    launch counts of that run, the store, the embedder, the hybrid query
    batch and the ingested documents."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
    from archi_tpu_torch.ops import LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 9)))
             for _ in range(5000)]
    # ~100-word chunks: about 100 tokens, the encoder's 128 bucket
    docs = synthetic_texts(rng, vocab, N_DOCS, 96, prefix="doc")
    fill_texts = synthetic_texts(rng, vocab, N_ROWS - N_DOCS, 5)

    t0 = time.perf_counter()
    # no vocab.txt is in the repository: a word-level WordPiece vocab of
    # the corpus, at MiniLM's vocabulary size
    tok = WordPieceTokenizer.build_vocab(docs, size=30522)
    emb = TorchEmbedder(config=BertConfig.minilm_l6(), tokenizer=tok,
                        seed=SEED)
    store = TorchVectorStore(emb)
    log(f"  MiniLM-L6 embedder + store built in "
        f"{time.perf_counter() - t0:.1f} s (bf16, random weights, seed {SEED})")

    # ---- the main path, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    doc_ids = store.add_texts(
        docs, metadatas=[{"resource_hash": f"r{i % 64}",
                          "kind": "even" if i % 2 == 0 else "odd"}
                         for i in range(N_DOCS)])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    log(f"  ingested {N_DOCS} documents through the encoder in "
        f"{t_ingest:.2f} s ({N_DOCS / t_ingest:.0f} docs/s, tokenizer "
        f"included)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.perf_counter()
    for s0 in range(0, len(fill_texts), FILL_BATCH):
        chunk = fill_texts[s0:s0 + FILL_BATCH]
        store.add_texts(chunk, embeddings=torch.randn(
            len(chunk), emb.dim, device="cuda", generator=g))
    torch.cuda.synchronize()
    log(f"  filled the index to {store.count()} rows in "
        f"{time.perf_counter() - t0:.1f} s (capacity {store.index.capacity})")
    check(store.count() == N_ROWS and store.index.capacity == N_CAPACITY,
          "index fill (rows, capacity)")

    probes = list(range(0, N_DOCS, N_DOCS // 8))
    t0 = time.perf_counter()
    for i in probes:
        top = store.similarity_search_with_score(docs[i], k=5)
        check(ids_of(top)[0] == doc_ids[i],
              f"semantic: doc {i} does not retrieve itself at rank 1")
        top = store.hybrid_search(docs[i], k=5)
        check(ids_of(top)[0] == doc_ids[i],
              f"hybrid: doc {i} does not retrieve itself at rank 1")
    log(f"  {len(probes)} documents retrieve themselves at rank 1 "
        f"(semantic and hybrid) in {time.perf_counter() - t0:.2f} s")
    hybrid_q = ([docs[i] for i in range(0, N_DOCS, N_DOCS // 24)][:24]
                + [" ".join(vocab[j] for j in (3, 17)), vocab[40],
                   "zzzzqx unmatched query", vocab[1] + " " + vocab[900]]
                + [docs[7][:40], docs[8][:30], docs[9][-30:], vocab[123]])
    check(len(hybrid_q) == 32, "hybrid batch size")
    hybrid = store.hybrid_search_batch(hybrid_q, k=10)
    filtered = store.hybrid_search_batch(hybrid_q[:8], k=10,
                                         filter={"kind": "even"})
    semantic32 = store.similarity_search_batch(hybrid_q, k=10)
    semantic256 = store.similarity_search_batch(
        [docs[i] for i in range(256)], k=10)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    fallbacks = engine_topk.FUSED_FALLBACKS["count"]
    log(f"  main-path launches {launches}, top-k fallbacks {fallbacks}")
    check(launches["fused_topk"] > 0, "fused_topk never launched")
    check(launches["encoder_attention"] > 0,
          "encoder_attention never launched")
    check(fallbacks == 0, "the top-k fell back to the plain version")

    # ---- checks against a brute-force scan of the same tensors
    check(all(len(r) == 10 for r in hybrid + semantic32 + semantic256),
          "short result lists")
    check(all(d.metadata["kind"] == "even" for r in filtered for d, _ in r),
          "filter leaked rows")
    check(all(ids_of(semantic256[i])[0] == doc_ids[i] for i in range(256)),
          "batched semantic: a document misses itself at rank 1")
    brute = brute_force_hybrid(store, hybrid_q, 10)
    bad = [i for i, (g_, w_) in enumerate(zip(hybrid, brute))
           if not same_ranking(g_, w_)]
    check(not bad, f"hybrid batch differs from brute force at {bad}")
    fallback_row = hybrid_q.index("zzzzqx unmatched query")
    check(same_ranking(hybrid[fallback_row], store.similarity_search_with_score(
        hybrid_q[fallback_row], k=10)), "BM25-empty query did not fall back")
    log("  hybrid batch (B=32, per-query bias) matches the brute-force scan; "
        "filter, fallback and self-retrieval hold")

    # ---- encoder output against the same weights on the CPU
    cpu = TorchEmbedder(config=BertConfig.minilm_l6(), tokenizer=tok,
                        seed=SEED, device="cpu")
    small = docs[:8]
    a, b = emb.encode_numpy(small), cpu.encode_numpy(small)
    cos = float(np.min(np.sum(a * b, axis=1)))
    # runs on an H100 measure 0.999997 (bf16 rounding); the limit allows
    # about 30 times that gap from 1
    check(np.isfinite(a).all() and a.shape == (8, 384) and cos >= 0.9999,
          f"encoder on the card vs CPU f32: min cosine {cos:.5f}")
    log(f"  encoder bf16 on the card vs f32 on the CPU: min cosine {cos:.5f}")
    results["e2e"] = {"ingest_docs_per_s": N_DOCS / t_ingest,
                      "encoder_cosine_vs_cpu_f32": cos}
    return launches, store, emb, hybrid_q, docs


def timings(results, store, emb, hybrid_q, docs):
    """Phase 4: encoder and query times on the card, and where the time of
    a batched hybrid search and of ingest goes."""
    import numpy as np
    import torch

    from archi_tpu_torch.models.bert import encode

    rng = np.random.default_rng(SEED + 2)
    ids = torch.from_numpy(rng.integers(1000, 30000, (256, 128))).cuda()
    mask = torch.ones(256, 128, dtype=torch.long, device="cuda")
    ms = cuda_ms(lambda: encode(emb.model, ids, mask), iters=10)
    e2e = results["e2e"]
    e2e["encoder_ms_b256_s128"] = ms
    e2e["encoder_chunks_per_s_b256_s128"] = 256 / ms * 1e3
    for b in (32, 256):
        q = torch.randn(b, 384, device="cuda")
        ms = cuda_ms(lambda: store.index.search_dispatch(q, k=10), iters=10)
        e2e[f"search_ms_b{b}"] = ms
        e2e[f"search_qps_b{b}"] = b / ms * 1e3
    store.hybrid_search_batch(hybrid_q, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        store.hybrid_search_batch(hybrid_q, k=10)
    torch.cuda.synchronize()
    t = (time.perf_counter() - t0) / reps
    e2e["hybrid_batch32_s"] = t
    e2e["hybrid_qps_b32"] = 32 / t
    t0 = time.perf_counter()
    for q in hybrid_q[:8]:
        store.hybrid_search(q, k=10)
    e2e["hybrid_single_ms"] = (time.perf_counter() - t0) / 8 * 1e3
    log("  " + json.dumps(e2e))

    # where the time of the two store calls goes (host clock, synchronised)
    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    w = 0.3 / 0.7
    bm, t_bm25 = stage(lambda: torch.stack(
        [store.bm25.scores(q, store.index.capacity) for q in hybrid_q]))
    embs, t_embed = stage(lambda: store._embed_queries(hybrid_q))
    (_, vals, rows), t_scan = stage(
        lambda: store.index.search(embs, k=10, bias=bm * w))
    _, t_rows = stage(lambda: [store._rows_to_results(rows[b], vals[b])
                               for b in range(len(hybrid_q))])
    docs = docs[:1024]
    id_lists, t_tok = stage(
        lambda: [emb.tokenizer.encode(t, emb.max_length) for t in docs])
    _, t_enc = stage(lambda: emb.encode_ids(id_lists))
    _, t_ana = stage(lambda: store.bm25.analyze_batch(docs))
    results["breakdown"] = {
        "hybrid_batch32_ms": {"bm25_scores": t_bm25 * 1e3,
                              "embed_queries": t_embed * 1e3,
                              "index_search": t_scan * 1e3,
                              "rows_to_results": t_rows * 1e3},
        "ingest_1024_docs_ms": {"tokenize": t_tok * 1e3,
                                "encode": t_enc * 1e3,
                                "bm25_analyze": t_ana * 1e3}}
    log("  breakdown " + json.dumps(results["breakdown"]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from archi_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log("phase 1: build")
    secs = _build.build()
    for name, out in sorted(_build.BUILD_LOGS.items()):
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in out.splitlines() if "Used " in line})
        log(f"  {name}: {regs}")
    log(f"  built {_build.sources()} in {secs:.1f} s")

    log("phase 2: kernels against their plain versions")
    results: dict = {"card": card, "build_s": secs}
    bf16 = torch.bfloat16
    topk = [
        # the main path's shapes: 2^20 live rows in a 2^21-row index
        topk_case("topk_b32_shared_bf16", 32, N_CAPACITY, N_ROWS, bf16,
                  False, timed=True),
        topk_case("topk_b256_shared_bf16", 256, N_CAPACITY, N_ROWS, bf16,
                  False, timed=True),
        topk_case("topk_b32_perquery_bf16", 32, N_CAPACITY, N_ROWS, bf16,
                  True, timed=True),
        topk_case("topk_b1_k5_bf16", 1, N_CAPACITY, N_ROWS, bf16, False, k=5),
        topk_case("topk_b1_k128_bf16", 1, N_CAPACITY, N_ROWS, bf16, True,
                  k=128),
        # a full 2^20-row index, the other storage types, a ragged edge
        topk_case("topk_b256_perquery_bf16", 256, N_ROWS, N_ROWS, bf16, True,
                  timed=True),
        topk_case("topk_b32_ragged_f32", 32, N_ROWS - 1003, N_ROWS - 5000,
                  torch.float32, False, timed=True),
        topk_case("topk_b32_int8", 32, N_ROWS, N_ROWS, torch.int8, False,
                  timed=True),
    ]
    attn = [
        # ingest (256 chunks in the 128 bucket) and queries (the 64 bucket,
        # batch buckets 8 and 32)
        attention_case("attn_b256_s128_bf16", 256, 128, torch.bfloat16,
                       timed=True),
        attention_case("attn_b8_s64_bf16", 8, 64, torch.bfloat16, timed=True),
        attention_case("attn_b32_s64_bf16", 32, 64, torch.bfloat16,
                       timed=True),
        attention_case("attn_b256_s512_bf16", 256, 512, torch.bfloat16,
                       timed=True),
        attention_case("attn_b256_s128_f32", 256, 128, torch.float32,
                       timed=True),
        attention_case("attn_b256_s512_f32", 256, 512, torch.float32),
    ]
    results["topk"], results["attention"] = topk, attn
    torch.cuda.empty_cache()

    log("phase 3: main path (MiniLM-L6 TorchEmbedder -> TorchVectorStore)")
    launches, store, emb, hybrid_q, docs = main_path(results)

    log("phase 4: timings")
    timings(results, store, emb, hybrid_q, docs)
    results["launches"] = launches
    results["seconds"] = time.perf_counter() - t_start
    log("detail " + json.dumps(results))

    def entry(name, source, replaces, headline, cases):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": headline["ms"], "plain_ms": headline["plain_ms"],
                "bound_ms": headline["bound_ms"],
                "bound_by": headline["bound_by"],
                "library_ms": headline["library_ms"]}

    kernels = [
        entry("fused_topk", "archi_tpu_torch/csrc/fused_topk.cu",
              "archi_tpu/ops/pallas_topk.py:261", topk[0], topk),
        entry("encoder_attention", "archi_tpu_torch/csrc/encoder_attention.cu",
              "archi_tpu/ops/pallas_attention.py:97", attn[0], attn),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
