#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's hybrid-retrieval main path on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each fails the run with a non-zero exit):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels of ``archi_tpu_torch/csrc`` from source, logging each
     kernel's registers, spills and static shared memory (ptxas);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives them (2^20 live rows of 384 in a 2^21-row
     index; MiniLM-L6's attention at the ingest and query buckets) and a
     few more, and time kernel (CUDA graph and CUDA events), plain version
     and a one-call PyTorch yardstick (``torch._int_mm`` for int8 top-k);
  3. run the main path through ``TorchVectorStore`` over a MiniLM-L6
     ``TorchEmbedder`` at full width (random weights from a seed): ingest
     documents through the encoder, fill the index to 2^20 rows, run
     semantic and hybrid searches, check them against a brute-force scan of
     the same tensors, and check that both kernels' launch counters rose
     during that run, every launch on the tensor-core route (the index and
     the encoder are bf16), while the top-k fallback counter stayed at 0;
  4. time the encoder and the query paths with CUDA events;
  5. path A, ``type: ivfpq`` serving: ``TorchVectorStore`` over
     ``AnnFlatIndex(snapshot_kind="ivfpq")`` at the bootstrap's defaults,
     documents through the encoder and a clustered corpus filled to 2^22
     rows, the snapshot built, searched through the 8-bit ADC kernel and
     the fresh tail, and checked (self-retrieval, kernel against the plain
     ADC, filter, recall@10 against the exact scan, fresh rows, a
     save/load round trip of the snapshot);
  6. path B, the XL tier's snapshot: ``IVFPQIndex.build_streaming`` over
     the same rows with packed 4-bit codes, block-budget probing through the
     4-bit ADC kernel and the host exact rerank, checked the same way;
  7. the service layer, through ``archi_tpu_torch.bin.bootstrap``'s
     ``build_vectorstore``: (a) phase 3's encoder written as a local HF
     snapshot and its store as ``engine_checkpoint``, restored with
     micro-batching at the defaults and served to 64 concurrent clients
     (512 hybrid requests, each held against the direct path), then the
     top 50 hybrid candidates of 8 queries reranked by ``MaxSimReranker``
     (against the same weights on the CPU); (b) the same checkpoint restored
     as a hot-tail index, 1024 documents ingested into the tail and merged
     while 64 clients query; (c) ``type: ivfpq_xl`` at the bootstrap's
     defaults, 2^20 clustered rows, a snapshot, 4096 documents in the exact
     tail, micro-batched hybrid and semantic queries, recall, exact scores
     and a save/load round trip.

Phase 2 also holds both ADC kernels against their plain versions at the
shapes of paths A and B, and times them with the codes in L2, just
rewritten (warm) and flushed from L2 (cold); phases 5 and 6 fail unless
every ADC launch of their path took the vectorised route; phase 7 fails
unless every launch of its parts took the tensor-core or the vectorised
route.  The last two lines are a JSON object listing the kernels and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
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
# paths A and B: the ivfpq tier over a clustered corpus (64 near-duplicates
# per cluster, the model of archi_tpu/benchmarking/synth_corpus.py)
PATH_ROWS = 1 << 22
PATH_DOCS = 1024
XL_BLOCK_ROWS = 1 << 17
# phase 7, the service layer
SVC_CLIENTS = 64           # concurrent clients (7a, 7b, 7c)
SVC_CALLS = 8              # store calls a client
HOT_DOCS = 1024            # documents ingested into the hot tail (7b)
XL_ROWS = 1 << 20          # clustered rows of the XL store (7c)
XL_DOCS = 4096             # documents in its exact tail
RERANK_QUERIES = 8
RERANK_TOP = 50
#: where the service phase runs: the card (the CPU only in a rehearsal of
#: the phase at small sizes)
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
SERVICE_TMP = os.path.join(ROOT, ".chip_tmp", "service")


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


def graph_ms(fn, iters: int = 20, calls: int = 1) -> float:
    """Device time of one fn() in ms without the host's launch overhead: fn
    captured `calls` times in a CUDA graph (several, where one call is
    shorter than the host's replay of a graph), replayed `iters` times
    between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / calls


def kernel_resources(ptxas_log: str) -> dict[str, str]:
    """Registers, spills and static shared memory of each kernel, from the
    ``-Xptxas -v`` output of one source (names cut to kernel and template
    arguments)."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = re.search(r"([a-z][a-z_]*_kernel)((?:I.*?E)(?=EEv))?",
                             mangled)
            name = (base.group(1) + (base.group(2) or "")) if base else mangled
        elif name and "spill stores" in line:
            out[name] = line.strip()
        elif name and "Used " in line:
            out[name] = (out.get(name, "") + "; "
                         + line.split("ptxas info    : ")[-1]).strip("; ")
    return out


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
        # device time of one call from a CUDA graph, and CUDA events over
        # the wrapper called 10 times
        res["ms"] = graph_ms(lambda: fused_topk(q, e, bias, n_active, k=k))
        res["ms_events"] = cuda_ms(lambda: fused_topk(q, e, bias, n_active,
                                                      k=k))
        res["plain_ms"] = cuda_ms(
            lambda: plain_topk(q, e, bias, n_active, k=k), iters=3, warmup=1)
        # the same function over the live rows (n_active >= k here)
        e_live, bias_live = e[:n_active], bias[..., :n_active]
        if dtype == torch.int8:
            # int8 x int8 -> int32 (cuBLASLt), scaled as the kernel scales
            q8 = quantize_int8(q)

            def library():
                s = (torch._int_mm(q8, e_live.T).float()
                     * (1.0 / (127.0 * 127.0)) + bias_live)
                return torch.topk(s, k, dim=1)
        else:
            def library():
                s = (q.to(dtype) @ e_live.T).float() + bias_live
                return torch.topk(s, k, dim=1)
        try:
            lib_vals = library().values
            res["library_max_abs_err"] = float((lib_vals - ref_vals).abs().max())
            res["library_ms"] = graph_ms(library)
            res["library_ms_events"] = cuda_ms(library)
        except RuntimeError as exc:     # the library refuses this shape
            res["library_ms"] = None
            res["library_refused"] = str(exc).splitlines()[0]
        # the function reads the live rows of E and of the bias only
        itemsize = e.element_size()
        bias_rows = b if per_query else 1
        nbytes = (n_active * d * itemsize + b * d * 4
                  + bias_rows * n_active * 4 + b * k * 8)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 2.0 * b * n_active * d, res["dtype"])
        log(f"    ms {res['ms']:.4f} (events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']} "
            f"{res.get('library_refused', '')}bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


def attention_case(name, b, s, dtype, nh=12, hd=32, timed=False):
    import torch
    import torch.nn.functional as F

    from archi_tpu_torch.ops.attention import (encoder_attention,
                                               p_rounding_bound,
                                               plain_attention)

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
    res = {"case": name, "B": b, "S": s, "nh": nh, "hd": hd,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err}
    if dtype == torch.float32:
        tol_desc, ok = "2e-5", err <= 2e-5
    else:
        # one bf16 step of the output, plus one bf16 step of each rounded
        # probability: both round p to bf16, from logits summed in another
        # order (ops/attention.py: p_rounding_bound)
        tol_desc = "2^-7*|ref| + 1e-3 + p_rounding_bound"
        flips = p_rounding_bound(q, k, v, key_bias, sm_scale=scale)
        step = ref.float().abs() * 2.0 ** -7 + 1e-3
        ok = bool((diff <= step + flips).all())
        # the share of outputs outside one bf16 step of the output alone
        res["beyond_one_step"] = float((diff > step).float().mean())
        del flips, step
    res["tol"] = tol_desc
    check(ok, f"{name}: max_abs_err {err:.3g} (tol {tol_desc})")
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol_desc}) ok")
    if timed:
        # device time of one call from a CUDA graph (the small query
        # buckets are as short as the wrapper's host work), and CUDA events
        # over the wrapper called 10 times
        res["ms"] = graph_ms(
            lambda: encoder_attention(q, k, v, key_bias, sm_scale=scale))
        res["ms_events"] = cuda_ms(
            lambda: encoder_attention(q, k, v, key_bias, sm_scale=scale))
        res["plain_ms"] = cuda_ms(
            lambda: plain_attention(q, k, v, key_bias, sm_scale=scale),
            iters=3, warmup=1)
        mask_t = key_bias.to(dtype)[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask_t, scale=scale)
        res["library_ms"] = graph_ms(library)
        res["library_ms_events"] = cuda_ms(library)
        itemsize = q.element_size()
        nbytes = 4 * b * s * h * itemsize + b * s * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 4.0 * b * nh * s * s * hd, res["dtype"])
        log(f"    ms {res['ms']:.4f} (events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']:.4f} (events "
            f"{res['library_ms_events']:.4f}) bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


def adc_case(name, m, g, s, packed, timed=False, ksub=256):
    """ADC kernel vs its plain version on one random input; returns a
    result dict.  The yardstick is ``F.embedding_bag`` over the
    bf16-rounded table (nibbles unpacked beforehand for 4-bit codes)."""
    import torch
    import torch.nn.functional as F

    from archi_tpu_torch.ops import ROUTE_LAUNCHES, adc

    dev = torch.device("cuda")
    g_ = torch.Generator(device="cuda").manual_seed(SEED + m + g + s)
    ksub = 16 if packed else ksub
    luts = torch.randn(m, g, ksub, device=dev, generator=g_)
    codes = torch.randint(0, ksub, (m, s), device=dev, generator=g_,
                          dtype=torch.uint8)
    if packed:
        codes_in = adc.pack_nibbles(codes.t()).t().contiguous()
        kernel, plain = adc.adc_scores_lut16, adc.plain_adc_scores_lut16
    else:
        codes_in, kernel, plain = codes, adc.adc_scores, adc.plain_adc_scores
    wrapper = "adc_scores_lut16" if packed else "adc_scores"
    before = dict(ROUTE_LAUNCHES)
    out = kernel(luts, codes_in)
    ref = plain(luts, codes_in)
    torch.cuda.synchronize()
    route = [k.split(":")[1] for k in ROUTE_LAUNCHES
             if k.startswith(wrapper + ":") and ROUTE_LAUNCHES[k] > before[k]]
    err = float((out - ref).abs().max())
    tol = 1e-5   # both sum the bf16 table in subspace order (0 expected)
    check(out.shape == (g, s) and bool(torch.isfinite(out).all())
          and err <= tol, f"{name}: max_abs_err {err:.3g} (tol {tol})")
    res = {"case": name, "m": m, "G": g, "S": s, "ksub": ksub,
           "packed": packed, "route": route[0], "max_abs_err": err,
           "tol": tol}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol}) ok, {route[0]} route")
    if timed:
        # device times from CUDA graphs of ten calls (a call is shorter than
        # the host's replay of a graph): replayed as they are (the codes stay
        # in L2); warm, each call after a copy that rewrites the codes, as
        # the candidate gather leaves them for the caller; cold, each call
        # after a 64 MB write that flushes the 50 MB L2.  The copy's and the
        # write's own graphs are timed and taken off.
        def call():
            return kernel(luts, codes_in)

        src = codes_in.clone()
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        res["ms"] = graph_ms(call, calls=10)
        res["ms_warm"] = (graph_ms(lambda: (codes_in.copy_(src), call()), calls=10)
                          - graph_ms(lambda: codes_in.copy_(src), calls=10))
        res["ms_cold"] = (graph_ms(lambda: (flush.zero_(), call()), calls=10)
                          - graph_ms(lambda: flush.zero_(), calls=10))
        del flush, src
        res["ms_events"] = cuda_ms(call)
        res["plain_ms"] = graph_ms(lambda: plain(luts, codes_in), iters=3)
        table = adc.round_lut(luts).permute(0, 2, 1).reshape(
            m * ksub, g).contiguous()
        bags = (codes.t().long()
                + ksub * torch.arange(m, device=dev)).contiguous()
        lib_err = float((F.embedding_bag(bags, table, mode="sum").t()
                         - ref).abs().max())
        res["library_ms"] = graph_ms(
            lambda: F.embedding_bag(bags, table, mode="sum"))
        res["library_max_abs_err"] = lib_err
        nbytes = codes_in.numel() + luts.numel() * 4 + g * s * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, m * g * s,
                                                 "float32")
        log(f"    ms {res['ms']:.4f} (warm {res['ms_warm']:.4f}, cold "
            f"{res['ms_cold']:.4f}, events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library "
            f"{res['library_ms']:.4f} (err {lib_err:.3g}) bound "
            f"{res['bound_ms']:.4f} ({res['bound_by']})")
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
    embs = torch.from_numpy(store._embed_queries(queries)).to(DEV)
    if hasattr(index, "main"):
        # hot tail: main's merged rows, then the tail, by global row
        nm = index.n_merged
        emb = torch.cat([index.main.emb[:nm], index.tail.emb])
        n_rows = nm + index.tail.n_rows
    else:
        emb, n_rows = index.emb, index.n_rows
    n = emb.shape[0]
    bias = alive_to_bias(index.alive[:n])[None, :] + bm[:, :n] * (w_b / w_sem)
    vals, rows = plain_topk(l2_normalize(embs), emb, bias, n_rows, k=k)
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
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

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
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    fallbacks = engine_topk.FUSED_FALLBACKS["count"]
    log(f"  main-path launches {launches}, routes {routes}, top-k fallbacks "
        f"{fallbacks}")
    check(launches["fused_topk"] > 0, "fused_topk never launched")
    check(launches["encoder_attention"] > 0,
          "encoder_attention never launched")
    # the index and the encoder are bf16: every launch on the tensor cores
    for name in ("fused_topk", "encoder_attention"):
        check(routes[f"{name}:tensor_core"] == launches[name],
              f"{name}: launches off the tensor-core route {routes}")
    results["routes"] = {"main": routes}
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
    return launches, store, emb, hybrid_q, docs, vocab


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


# ------------------------------------------------------------- phases 5-6
class ClusteredRows:
    """The clustered corpus of archi_tpu/benchmarking/synth_corpus.py, made
    on the card from a seed: PATH_ROWS / 64 standard-normal centres, each
    row a random centre + 0.3 sigma noise, renormalised (64 near-duplicates
    per cluster on average)."""

    def __init__(self, n_rows: int, seed: int, d: int = 384):
        import torch

        self.gen = torch.Generator(device=DEV).manual_seed(seed)
        self.centers = torch.randn(n_rows // 64, d, device=DEV,
                                   generator=self.gen)

    def rows(self, n: int, clusters=None):
        import torch

        if clusters is None:
            clusters = torch.randint(0, self.centers.shape[0], (n,),
                                     device=DEV, generator=self.gen)
        v = self.centers[clusters] + 0.3 * torch.randn(
            n, self.centers.shape[1], device=DEV, generator=self.gen)
        return torch.nn.functional.normalize(v, dim=1)


def same_rows(got_v, got_r, want_v, want_r, tol=1e-5):
    """Tie-aware: scores within tol position by position, and a row in one
    list only ties with the last score kept."""
    import numpy as np

    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    if got_v.shape != want_v.shape or np.abs(got_v - want_v).max() > tol:
        return False
    for b in range(got_v.shape[0]):
        g = dict(zip(np.asarray(got_r[b]).tolist(), got_v[b].tolist()))
        w = dict(zip(np.asarray(want_r[b]).tolist(), want_v[b].tolist()))
        if any(abs(g.get(r, w.get(r)) - want_v[b, -1]) > tol
               for r in set(g) ^ set(w)):
            return False
    return True


def recall_at_10(rows, exact_rows) -> float:
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(rows, exact_rows)) / (10 * len(exact_rows))


def exact_top10(emb, n_rows: int, q):
    """Exact top-10 rows of q over emb[:n_rows] (f32 products, chunked)."""
    import torch

    from archi_tpu_torch.engine.topk import topk_lower_first

    vals, rows = [], []
    for s0 in range(0, n_rows, 1 << 20):
        sc = q @ emb[s0:min(n_rows, s0 + (1 << 20))].float().T
        v, p = topk_lower_first(sc, 10)
        vals.append(v)
        rows.append(p + s0)
    v, p = topk_lower_first(torch.cat(vals, dim=1), 10)
    return torch.gather(torch.cat(rows, dim=1), 1, p).cpu().numpy()


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall time of fn() in ms, synchronised, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def path_a(results, emb, docs, vocab):
    """Phase 5: ``type: ivfpq`` serving at the bootstrap's defaults.
    Returns its launch counts, the store, the corpus generator and the
    recall queries."""
    import numpy as np
    import torch

    from archi_tpu_torch.bin.bootstrap import build_index
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.ann_index import AnnFlatIndex
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED + 5)
    docs = docs[:PATH_DOCS]
    fill_texts = synthetic_texts(rng, vocab, PATH_ROWS - PATH_DOCS, 3)
    corpus = ClusteredRows(PATH_ROWS, SEED + 6)
    # the bootstrap's `type: ivfpq` arguments, spelled out
    index = build_index(384, {
        "type": "ivfpq", "nlist": 1024, "nprobe": 64, "nprobe_blocks": None,
        "cell_gate": None, "block_rank_sub": 8, "min_snapshot_rows": 1 << 15,
        "pq_m": 48, "pq_refine_m": 48, "extract": "auto", "hier_t": 64,
        "async_refresh": True})
    check(isinstance(index, AnnFlatIndex) and index.snapshot_kind == "ivfpq",
          "build_index did not give an ivfpq AnnFlatIndex")
    store = TorchVectorStore(emb, index=index)
    out = {}

    # ---- the path, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    doc_ids = store.add_texts(
        docs, metadatas=[{"kind": "even" if i % 2 == 0 else "odd"}
                         for i in range(PATH_DOCS)])
    for s0 in range(0, len(fill_texts), FILL_BATCH):
        chunk = fill_texts[s0:s0 + FILL_BATCH]
        store.add_texts(chunk, embeddings=corpus.rows(len(chunk)))
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    out["rows"], out["capacity"] = store.count(), index.capacity
    log(f"  ingested {PATH_DOCS} documents and filled to {store.count()} "
        f"rows in {out['fill_s']:.1f} s (capacity {index.capacity})")
    check(store.count() == PATH_ROWS, "path A fill")
    t0 = time.perf_counter()
    index.refresh_ann()
    torch.cuda.synchronize()
    out["snapshot_build_s"] = time.perf_counter() - t0
    ivf = index._ivf
    check(ivf is not None and index._n_snap == PATH_ROWS, "no snapshot")
    out["n_blocks"], out["max_bpc"] = (int(ivf.code_blocks.shape[0]),
                                       int(ivf.cell_blocks.shape[1]))
    out["adc_candidates_per_query"] = 64 * out["max_bpc"] * 512
    log(f"  ivfpq snapshot built in {out['snapshot_build_s']:.1f} s "
        f"({out['n_blocks']} blocks, max {out['max_bpc']} a cell)")

    probes = list(range(0, PATH_DOCS, PATH_DOCS // 16))
    sem_self = sum(ids_of(store.similarity_search_with_score(
        docs[i], k=5))[:1] == [doc_ids[i]] for i in probes)
    hyb_self = sum(ids_of(store.hybrid_search(docs[i], k=5))[:1]
                   == [doc_ids[i]] for i in probes)
    q_docs = [docs[i] for i in range(0, PATH_DOCS, PATH_DOCS // 32)]
    semantic = store.similarity_search_batch(q_docs, k=10)
    hybrid = store.hybrid_search_batch(q_docs, k=10)
    filtered = store.hybrid_search_batch(q_docs[:8], k=10,
                                         filter={"kind": "even"})
    stored = torch.arange(PATH_DOCS, PATH_ROWS, (PATH_ROWS - PATH_DOCS) // 32,
                          device="cuda")[:32]
    _i, _v, stored_top = index.search(index.emb[stored].float(), k=10)
    fresh = corpus.rows(4096)
    store.add_texts(synthetic_texts(rng, vocab, 4096, 3), embeddings=fresh)
    _i, fresh_v, fresh_top = index.search(fresh[::128], k=10)
    torch.cuda.synchronize()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    log(f"  path A launches {launches}, routes {routes}, top-k fallbacks "
        f"{engine_topk.FUSED_FALLBACKS['count']}")
    for name in ("adc_scores", "fused_topk", "encoder_attention"):
        check(launches[name] > 0, f"path A: {name} never launched")
    for name in ("fused_topk", "encoder_attention"):
        check(routes[f"{name}:tensor_core"] == launches[name],
              f"path A: {name} launches off the tensor-core route {routes}")
    # the candidate sets are whole blocks of 512 codes: vectorised loads
    check(routes["adc_scores:vector"] == launches["adc_scores"],
          f"path A: adc_scores launches off the vectorised route {routes}")
    results.setdefault("routes", {})["path_a"] = routes
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "top-k fell back")

    # ---- checks.  Limits from the first card runs (PERF.md): stored
    # rows and documents (hybrid) read 1.0; recall@10 read 0.781 and 0.756,
    # so its limit leaves room for spread between runs (random candidates
    # would read near 0).  Documents through the random-weight encoder
    # lie within about 1e-2 of each other in cosine, under the PQ error, so
    # semantic self-retrieval of documents is a reading, not a check
    # (0.0625 in both runs).
    out["self_rank1_docs_semantic"] = sem_self / len(probes)
    out["self_rank1_docs_hybrid"] = hyb_self / len(probes)
    out["self_rank1_stored_rows"] = float(np.mean(
        stored_top[:, 0] == stored.cpu().numpy()))
    pe = emb.encode_numpy([docs[i] for i in probes])
    cos = pe @ pe.T
    out["probe_docs_mean_cosine"] = float(
        (cos.sum() - np.trace(cos)) / (len(probes) * (len(probes) - 1)))
    check(out["self_rank1_docs_hybrid"] >= 0.9
          and out["self_rank1_stored_rows"] >= 0.9,
          f"path A self-retrieval: {out}")
    check(all(len(r) == 10 for r in semantic + hybrid), "short results")
    check(all(d.metadata["kind"] == "even" for r in filtered for d, _ in r),
          "filter leaked rows")
    fresh_rows = np.arange(PATH_ROWS, PATH_ROWS + 4096, 128)
    check(bool((fresh_top[:, 0] == fresh_rows).all())
          and bool((fresh_v[:, 0] > 0.99).all()),
          "fresh rows not found through the tail")
    # the same B=32 batches (now over the fresh rows too) with the kernel
    # and with the plain ADC
    with_kernel = (store.similarity_search_batch(q_docs, k=10)
                   + store.hybrid_search_batch(q_docs, k=10))
    index.adc_impl = "plain"
    with_plain = (store.similarity_search_batch(q_docs, k=10)
                  + store.hybrid_search_batch(q_docs, k=10))
    index.adc_impl = None
    bad = [i for i, (a, b) in enumerate(zip(with_kernel, with_plain))
           if not same_ranking(a, b, tol=1e-5)]
    check(not bad, f"kernel and plain ADC differ at {bad}")
    queries = corpus.rows(32)
    _i, _v, ann_rows = index.search(queries, k=10)
    exact = exact_top10(index.emb, index.n_rows, queries)
    out["recall_at_10"] = recall_at_10(ann_rows, exact)
    check(out["recall_at_10"] >= 0.6,
          f"path A recall@10 {out['recall_at_10']:.3f} < 0.6")
    log(f"  probe documents' mean cosine {out['probe_docs_mean_cosine']:.4f}")
    log(f"  self rank-1: docs semantic {out['self_rank1_docs_semantic']:.3f} "
        f"hybrid {out['self_rank1_docs_hybrid']:.3f}, stored rows "
        f"{out['self_rank1_stored_rows']:.3f}; recall@10 "
        f"{out['recall_at_10']:.3f}; kernel == plain ADC on B=32 semantic "
        f"and hybrid; filter and fresh tail hold")

    # ---- save/load round trip of the snapshot sidecar
    tmp = os.path.join(ROOT, ".chip_tmp", "path_a")
    os.makedirs(tmp, exist_ok=True)
    try:
        before = index.search(queries, k=10)
        t0 = time.perf_counter()
        path = os.path.join(tmp, "index.npz")
        ivf.save(path + ".ann.npz")
        with open(path + ".ann.json", "w") as f:
            json.dump({"n_snap": PATH_ROWS, "kind": "ivfpq"}, f)
        check(index.adopt_snapshot(path, warm=False), "snapshot not adopted")
        after = index.search(queries, k=10)
        out["snapshot_save_load_s"] = time.perf_counter() - t0
        check(index._ivf is not ivf and same_rows(after[1], after[2],
                                                  before[1], before[2], 0.0),
              "save/load round trip changed the results")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  snapshot save/load round trip in "
        f"{out['snapshot_save_load_s']:.1f} s returns the same results")

    # ---- times (host clock, synchronised)
    q_emb = torch.from_numpy(store._embed_queries(q_docs)).cuda()
    out["semantic_index_ms_b32"] = host_ms(lambda: index.search(q_emb, k=10))
    out["semantic_store_ms_b32"] = host_ms(
        lambda: store.similarity_search_batch(q_docs, k=10))
    out["hybrid_store_ms_b32"] = host_ms(
        lambda: store.hybrid_search_batch(q_docs, k=10))
    for key in ("semantic_index", "semantic_store", "hybrid_store"):
        out[f"{key}_qps_b32"] = 32 / out[f"{key}_ms_b32"] * 1e3
    row_bias = torch.zeros(index.capacity, device="cuda")
    out["ann_dispatch_ms_b32"] = host_ms(lambda: index._ivf.search_dispatch(
        q_emb, k=40, nprobe=64, bias=row_bias, normalize_queries=False,
        refine_overfetch=1))
    log("  " + json.dumps(out))
    results["path_a"] = out
    return launches, store, corpus, queries, exact


def path_b(results, index_a, corpus):
    """Phase 6: the XL tier's snapshot over path A's first PATH_ROWS rows
    (engine/xl_index.py's build and search arguments)."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.host_store import HostVectorStore, exact_rerank
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    emb = index_a.emb
    n_blocks = PATH_ROWS // XL_BLOCK_ROWS
    out = {}
    t0 = time.perf_counter()
    host = HostVectorStore(384, capacity=PATH_ROWS)
    for i in range(n_blocks):
        host.add(emb[i * XL_BLOCK_ROWS:(i + 1) * XL_BLOCK_ROWS]
                 .half().cpu().numpy())
    out["host_store_fill_s"] = time.perf_counter() - t0

    def block_fn(i):
        return emb[i * XL_BLOCK_ROWS:(i + 1) * XL_BLOCK_ROWS].float()

    queries = corpus.rows(32)
    q_np = queries.cpu().numpy()
    bias = torch.zeros(PATH_ROWS, device="cuda")

    def search(adc_impl=None):
        vals, rows = ivf.search_dispatch(
            queries, k=160, nprobe_blocks=128, cell_gate=None, bias=bias,
            normalize_queries=False, refine_overfetch=1, extract="auto",
            hier_t=64, adc_impl=adc_impl)
        return vals.cpu().numpy(), rows.cpu().numpy()

    reset_launches()
    t0 = time.perf_counter()
    ivf = IVFPQIndex.build_streaming(
        block_fn, n_blocks, XL_BLOCK_ROWS, nlist=4096, block=512, m=48,
        ksub=16, refine_m=48, train_blocks=2, spill_frac=0.0, opq_iters=0)
    ivf.ensure_block_centroids(dtype=torch.bfloat16, sub=8)
    torch.cuda.synchronize()
    out["snapshot_build_s"] = time.perf_counter() - t0
    out["n_blocks"] = int(ivf.code_blocks.shape[0])
    check(ivf.packed and ivf.code_blocks.shape[2] == 24, "codes not packed")
    cand_v, cand_r = search()
    vals, rows = exact_rerank(host, q_np, cand_v, cand_r, k=10)
    torch.cuda.synchronize()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    log(f"  XL snapshot built in {out['snapshot_build_s']:.1f} s "
        f"({out['n_blocks']} blocks); launches {launches}, routes {routes}")
    check(launches["adc_scores_lut16"] > 0,
          "path B: adc_scores_lut16 never launched")
    check(routes["adc_scores_lut16:vector"] == launches["adc_scores_lut16"],
          f"path B: adc_scores_lut16 launches off the vectorised route {routes}")
    results["routes"]["path_b"] = routes

    plain_v, plain_r = search("plain")
    check(same_rows(cand_v, cand_r, plain_v, plain_r),
          "path B: kernel and plain ADC differ")
    exact = exact_top10(emb, PATH_ROWS, queries)
    out["recall_at_10"] = recall_at_10(rows, exact)
    stored = np.arange(0, PATH_ROWS, PATH_ROWS // 32)[:32]
    sq = emb[torch.as_tensor(stored, device="cuda")].float()
    sv, sr = ivf.search_dispatch(sq, k=160, nprobe_blocks=128, bias=bias,
                                 normalize_queries=False, refine_overfetch=1)
    _v, self_rows = exact_rerank(host, sq.cpu().numpy(), sv.cpu().numpy(),
                                 sr.cpu().numpy(), k=10)
    out["self_rank1_stored_rows"] = float(np.mean(self_rows[:, 0] == stored))
    # limits from the first card run (PERF.md): both read 1.0
    check(bool(np.isfinite(vals).all()) and vals.shape == (32, 10)
          and out["recall_at_10"] >= 0.9
          and out["self_rank1_stored_rows"] >= 0.9, f"path B results {out}")
    out["search_ms_b32"] = host_ms(lambda: exact_rerank(
        host, q_np, *search(), k=10))
    out["search_qps_b32"] = 32 / out["search_ms_b32"] * 1e3
    out["dispatch_ms_b32"] = host_ms(search)
    log(f"  recall@10 {out['recall_at_10']:.3f}, stored rows self rank-1 "
        f"{out['self_rank1_stored_rows']:.3f}; kernel == plain ADC")
    log("  " + json.dumps(out))
    results["path_b"] = out
    return launches


# ------------------------------------------------------------------ phase 7
def save_hf_snapshot(emb, directory: str) -> None:
    """Write a ``TorchEmbedder`` as a local HF snapshot: ``config.json``,
    ``vocab.txt`` and ``pytorch_model.bin`` under the names
    ``hf_loader.params_from_state_dict`` reads (linear weights as the
    encoder holds them, upcast to f32)."""
    import torch

    os.makedirs(directory, exist_ok=True)
    c, m = emb.config, emb.model
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                   "num_hidden_layers": c.num_layers,
                   "num_attention_heads": c.num_heads,
                   "intermediate_size": c.intermediate_size,
                   "max_position_embeddings": c.max_position_embeddings,
                   "type_vocab_size": c.type_vocab_size,
                   "layer_norm_eps": c.layer_norm_eps}, f)
    emb.tokenizer.save_vocab(os.path.join(directory, "vocab.txt"))
    sd = {"embeddings.word_embeddings.weight": m.word.weight,
          "embeddings.position_embeddings.weight": m.position.weight,
          "embeddings.token_type_embeddings.weight": m.token_type.weight,
          "embeddings.LayerNorm.weight": m.emb_ln.weight,
          "embeddings.LayerNorm.bias": m.emb_ln.bias}
    h = c.hidden_size
    for i, layer in enumerate(m.layers):
        p = f"encoder.layer.{i}."
        for j, name in enumerate(("query", "key", "value")):
            sd[p + f"attention.self.{name}.weight"] = \
                layer.qkv.weight[j * h:(j + 1) * h]
            sd[p + f"attention.self.{name}.bias"] = \
                layer.qkv.bias[j * h:(j + 1) * h]
        for hf, mod in (("attention.output.dense", layer.o),
                        ("attention.output.LayerNorm", layer.attn_ln),
                        ("intermediate.dense", layer.ffn_i),
                        ("output.dense", layer.ffn_o),
                        ("output.LayerNorm", layer.ffn_ln)):
            sd[p + hf + ".weight"] = mod.weight
            sd[p + hf + ".bias"] = mod.bias
    torch.save({k: v.detach().float().cpu().contiguous()
                for k, v in sd.items()},
               os.path.join(directory, "pytorch_model.bin"))


def write_service_checkpoint(results, store, emb) -> None:
    """Phase 7's inputs: phase 3's encoder as a local HF snapshot and its
    store as ``<data>/engine_checkpoint`` under ``SERVICE_TMP``."""
    shutil.rmtree(SERVICE_TMP, ignore_errors=True)
    save_hf_snapshot(emb, os.path.join(SERVICE_TMP, "model"))
    t0 = time.perf_counter()
    store.save(os.path.join(SERVICE_TMP, "data", "engine_checkpoint"))
    results["service"] = {"rows": store.count(),
                          "checkpoint_save_s": time.perf_counter() - t0}
    log(f"  {store.count()} rows saved as engine_checkpoint in "
        f"{results['service']['checkpoint_save_s']:.1f} s; the encoder as a "
        f"local HF snapshot")


def sync() -> None:
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def check_routes(part: str, launches: dict, routes: dict,
                 names=("fused_topk", "encoder_attention")) -> None:
    """Every named kernel launched in the part, each launch on its fast
    route (tensor cores for bf16 top-k and attention, vectorised code loads
    for the ADC kernels)."""
    for name in names:
        route = "vector" if name.startswith("adc") else "tensor_core"
        check(launches[name] > 0, f"{part}: {name} never launched")
        check(routes[f"{name}:{route}"] == launches[name],
              f"{part}: {name} launches off the {route} route {routes}")


def run_clients(store, requests, during=None):
    """``requests[c]`` = the (kind, query) calls of client c, each made from
    its own thread in turn (kind "hybrid" or "semantic", k=10).  ``during``
    runs on this thread once a quarter of the calls have returned.
    → (results by (c, j), latencies s, wall s)."""
    import threading

    out, lat, errors = {}, [], []
    lock = threading.Lock()
    quarter = threading.Event()
    n_calls = sum(len(r) for r in requests)

    def client(c):
        try:
            for j, (kind, q) in enumerate(requests[c]):
                t0 = time.perf_counter()
                r = (store.hybrid_search(q, k=10) if kind == "hybrid"
                     else store.similarity_search_with_score(q, k=10))
                dt = time.perf_counter() - t0
                with lock:
                    out[(c, j)] = r
                    lat.append(dt)
                    if len(out) >= n_calls // 4:
                        quarter.set()
        except Exception as exc:   # reported below: the run fails
            with lock:
                errors.append(f"client {c}: {exc!r}")
            quarter.set()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        check(quarter.wait(600), "clients made no progress")
        during()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client did not finish")
    check(not errors, f"client errors {errors[:3]}")
    return out, lat, wall


def latency_ms(lat) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def short_query(rng, vocab) -> str:
    return " ".join(vocab[int(i)] for i in rng.integers(
        0, 2000, int(rng.integers(1, 4))))


def service_flat(results, docs, vocab):
    """7a: restore phase 3's checkpoint through ``build_vectorstore`` with
    micro-batching at the defaults, serve 512 hybrid requests from 64
    clients, hold each against the direct path, then rerank.  → launches by
    part."""
    import numpy as np

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.reranker import MaxSimReranker
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.utils.metrics import METRICS

    out = results["service"]
    model_dir = os.path.join(SERVICE_TMP, "model")
    dm = {"embedding_name": "minilm", "model_dir": model_dir,
          "data_path": os.path.join(SERVICE_TMP, "data"), "index": {},
          "serving": {"micro_batch": {"enabled": True}}}
    t0 = time.perf_counter()
    st = build_vectorstore(dm, device=DEV)
    out["restore_s"] = time.perf_counter() - t0
    b = st._batcher
    check(type(st.index) is FlatIndex and st.count() == out["rows"]
          and b is not None
          and (b.max_batch, b.max_wait_s, len(b._workers)) == (32, 0.004, 2),
          "7a: the restored store is not the checkpoint's, micro-batched at "
          "the defaults")
    log(f"  7a: restored {st.count()} rows in {out['restore_s']:.1f} s "
        f"(FlatIndex, micro-batching 32 / 4 ms / 2 workers)")

    rng = np.random.default_rng(SEED + 7)
    miss = "zzzzqx unmatched service query"
    check(float(st.bm25.scores(miss, st.index.capacity).max()) <= 0.0,
          "7a: the BM25-miss query matches")
    reqs = []
    for c in range(SVC_CLIENTS):
        calls = [("hybrid", docs[int(i)])
                 for i in rng.integers(0, len(docs), 4)]
        calls += [("hybrid", short_query(rng, vocab)) for _ in range(3)]
        calls.append(("hybrid", miss if c % 8 == 0
                      else short_query(rng, vocab)))
        reqs.append(calls)
    n_req = SVC_CLIENTS * SVC_CALLS

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    b0 = METRICS.counter_value("archi_micro_batches_total")
    r0 = METRICS.counter_value("archi_micro_batched_requests_total")
    got, lat, wall = run_clients(st, reqs)
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    batches = METRICS.counter_value("archi_micro_batches_total") - b0
    served = METRICS.counter_value("archi_micro_batched_requests_total") - r0
    check_routes("7a", launches, routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7a: top-k fell back")

    # the same requests one at a time from one thread, the direct path
    t0 = time.perf_counter()
    want = {(c, j): st._hybrid_search_impl(q, k=10)
            for c in range(SVC_CLIENTS) for j, (_k, q) in enumerate(reqs[c])}
    seq_wall = time.perf_counter() - t0
    bad = [key for key, w in want.items() if not same_ranking(got[key], w)]
    check(not bad, f"7a: micro-batched results differ from the direct path "
                   f"at {bad[:8]}")
    check(served == n_req and served / batches > 1,
          f"7a: {served} requests in {batches} batches")
    out["flat"] = {"requests": n_req, "batches": batches,
                   "mean_batch": served / batches,
                   "qps_micro_batched": n_req / wall,
                   "qps_request_at_a_time": n_req / seq_wall,
                   **latency_ms(lat)}
    log("  7a: " + json.dumps(out["flat"]))

    # ---- MaxSim rerank of hybrid candidates, card against the CPU in f32
    rq = [reqs[c][j][1] for c, j in ((0, 0), (1, 1), (2, 4), (3, 5),
                                     (4, 2), (5, 6), (6, 3), (0, 7))]
    cands = [st.hybrid_search(q, k=RERANK_TOP) for q in rq]
    check(all(len(c) == RERANK_TOP for c in cands), "7a: short candidates")
    reset_launches()
    card = [MaxSimReranker(st._embedding_function).rerank(q, c)
            for q, c in zip(rq, cands)]
    sync()
    rr_launches, rr_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("rerank", rr_launches, rr_routes, ("encoder_attention",))
    cpu_rr = MaxSimReranker(TorchEmbedder(model_dir=model_dir, device="cpu"))
    err = 0.0
    for q, c, got_ in zip(rq, cands, card):
        ref = {d.metadata["chunk_id"]: s for d, s in cpu_rr.rerank(q, c)}
        check(len(got_) == RERANK_TOP and len(ref) == RERANK_TOP,
              "7a: rerank lost candidates")
        err = max(err, max(abs(s - ref[d.metadata["chunk_id"]])
                           for d, s in got_))
    out["rerank_max_abs_err_vs_cpu_f32"] = err
    check(err <= 1e-3, f"7a: rerank scores off the CPU's by {err:.3g}")
    log(f"  rerank: top {RERANK_TOP} of {len(rq)} queries, scores within "
        f"{err:.3g} of the same weights on the CPU in f32 (limit 1e-3)")
    st._batcher.close()
    return {"service_flat": (launches, routes),
            "service_rerank": (rr_launches, rr_routes)}


def service_hot_tail(results, docs, vocab):
    """7b: the checkpoint restored as a hot-tail index, new documents into
    the tail, a merge while 64 clients query."""
    import numpy as np

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = results["service"]
    dm = {"embedding_name": "minilm",
          "model_dir": os.path.join(SERVICE_TMP, "model"),
          "data_path": os.path.join(SERVICE_TMP, "data"),
          "index": {"hot_tail": True},
          "serving": {"micro_batch": {"enabled": True}}}
    t0 = time.perf_counter()
    st = build_vectorstore(dm, device=DEV)
    restore_s = time.perf_counter() - t0
    idx = st.index
    n_main = out["rows"]
    check(isinstance(idx, SegmentedFlatIndex) and idx.n_merged == n_main
          and idx.tail.n_rows == 0, "7b: not a hot-tail index over the rows")
    rng = np.random.default_rng(SEED + 8)
    new_docs = synthetic_texts(rng, vocab, HOT_DOCS, 96, prefix="hot")

    reset_launches()
    t0 = time.perf_counter()
    new_ids = st.add_texts(new_docs)
    ingest_s = time.perf_counter() - t0
    check(idx.tail.n_rows == HOT_DOCS and idx.n_merged == n_main,
          "7b: the documents did not land in the tail")

    def self_rank(label):
        bad = []
        for s0 in range(0, HOT_DOCS, 32):
            res = st.hybrid_search_batch(new_docs[s0:s0 + 32], k=10)
            for i, r in enumerate(res):
                ids = ids_of(r)
                if ids[:1] != [new_ids[s0 + i]] or len(set(ids)) != len(ids):
                    bad.append(s0 + i)
        check(not bad, f"7b {label}: documents {bad[:8]} miss rank 1 or "
                       f"list a row twice")

    self_rank("before the merge")
    bq = new_docs[:16] + [docs[i] for i in range(0, len(docs),
                                                  len(docs) // 16)][:16]
    brute = brute_force_hybrid(st, bq, 10)
    bad = [i for i, (g, w) in enumerate(zip(st.hybrid_search_batch(bq, k=10),
                                            brute))
           if not same_ranking(g, w)]
    check(not bad, f"7b: hybrid batch differs from brute force at {bad}")

    per = HOT_DOCS // SVC_CLIENTS
    reqs = [[("hybrid", new_docs[c * per + j]) for j in range(per)]
            for c in range(SVC_CLIENTS)]
    merge_s = []

    def merge():
        t = time.perf_counter()
        idx.merge()
        merge_s.append(time.perf_counter() - t)

    got, lat, wall = run_clients(st, reqs, during=merge)
    bad = [(c, j) for (c, j), r in got.items()
           if ids_of(r)[:1] != [new_ids[c * per + j]]
           or len(set(ids_of(r))) != len(r)]
    check(not bad, f"7b: during the merge {bad[:8]} missed rank 1 or listed "
                   f"a row twice")
    check(idx.n_merged == n_main + HOT_DOCS and idx.tail.n_rows == 0
          and idx._merge_epoch == 1, "7b: the merge did not fold the tail")
    self_rank("after the merge")
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7b", launches, routes)
    out["hot_tail"] = {"restore_s": restore_s, "ingest_s": ingest_s,
                       "merge_s": merge_s[0], "requests_during_merge":
                       len(got), "qps_during_merge": len(got) / wall,
                       **latency_ms(lat)}
    log("  7b: " + json.dumps(out["hot_tail"]))
    st._batcher.close()
    return {"service_hot_tail": (launches, routes)}


def service_xl(results, vocab):
    """7c: ``type: ivfpq_xl`` at the bootstrap's defaults: clustered rows
    through ``add_texts``, a snapshot, documents in the exact tail,
    micro-batched hybrid and semantic queries, recall, exact scores and a
    save/load round trip."""
    import numpy as np
    import torch

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.xl_index import XlPQIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = {}
    xl_dir = os.path.join(SERVICE_TMP, "xl")
    dm = {"embedding_name": "minilm",
          "model_dir": os.path.join(SERVICE_TMP, "model"),
          "data_path": os.path.join(xl_dir, "data"),
          "index": {"type": "ivfpq_xl",
                    "store_path": os.path.join(xl_dir, "plane.bin")},
          "serving": {"micro_batch": {"enabled": True}}}
    st = build_vectorstore(dm, device=DEV)
    idx = st.index
    check(isinstance(idx, XlPQIndex) and st.count() == 0
          and (idx.nlist, idx.block, idx.pq_m, idx.pq_refine_m, idx.ksub,
               idx.nprobe_blocks, idx.build_block_rows, idx.async_refresh)
          == (4096, 512, 48, 48, 16, 128, 1 << 17, True),
          "7c: not an XL index at the bootstrap's defaults")
    rng = np.random.default_rng(SEED + 9)
    corpus = ClusteredRows(XL_ROWS, SEED + 10, d=idx.dim)
    fill = synthetic_texts(rng, vocab, XL_ROWS, 3)

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    for s0 in range(0, XL_ROWS, FILL_BATCH):
        chunk = fill[s0:s0 + FILL_BATCH]
        st.add_texts(chunk, embeddings=corpus.rows(len(chunk)))
    if idx._refresh_thread is not None:
        idx._refresh_thread.join()
    out["fill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.refresh_snapshot()
    out["snapshot_build_s"] = time.perf_counter() - t0
    check(idx._n_snap == XL_ROWS and idx._ivf.packed
          and idx.refresh_failures == 0, "7c: no whole-plane snapshot")
    out["n_blocks"] = int(idx._ivf.code_blocks.shape[0])
    xl_docs = synthetic_texts(rng, vocab, XL_DOCS, 96, prefix="xl")
    t0 = time.perf_counter()
    xl_ids = st.add_texts(xl_docs)
    out["ingest_s"] = time.perf_counter() - t0
    check(idx._n_snap == XL_ROWS and idx.n_rows == XL_ROWS + XL_DOCS
          and len(idx.tail) == XL_DOCS, "7c: documents not in the tail")
    log(f"  7c: filled {XL_ROWS} rows in {out['fill_s']:.1f} s, snapshot "
        f"({out['n_blocks']} blocks) in {out['snapshot_build_s']:.1f} s, "
        f"{XL_DOCS} documents into the exact tail")

    sem_q = [short_query(rng, vocab) for _ in range(SVC_CLIENTS * 4)]
    probe = rng.choice(XL_DOCS, SVC_CLIENTS * 4, replace=False)
    reqs = [[("hybrid", xl_docs[probe[c * 4 + j]]) for j in range(4)]
            + [("semantic", sem_q[c * 4 + j]) for j in range(4)]
            for c in range(SVC_CLIENTS)]
    got, lat, wall = run_clients(st, reqs)
    bad = [c for c in range(SVC_CLIENTS) for j in range(4)
           if ids_of(got[(c, j)])[:1] != [xl_ids[probe[c * 4 + j]]]]
    check(not bad, f"7c: fresh documents miss rank 1 ({len(bad)})")
    check(all(len(r) == 10 for r in got.values()), "7c: short results")

    # exact scores of one semantic batch against the host plane's rows
    qs = sem_q[:32]
    res = st.similarity_search_batch(qs, k=10)
    embs = st._embed_queries(qs)
    embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True),
                             1e-12)
    q_bf16 = torch.from_numpy(embs).bfloat16().float().numpy()
    err = 0.0
    for b, r in enumerate(res):
        for d, s in r:
            row = idx._id_rows[d.metadata["chunk_id"]][0]
            plane = idx.store.get([row])[0]
            # snapshot rows: the exact host rerank (f32 query); tail rows:
            # the bf16 top-k, which rounds the query to the rows' type
            q = embs[b] if row < idx._n_snap else q_bf16[b]
            err = max(err, abs(s - float(plane @ q)))
    out["score_max_abs_err_vs_plane"] = err
    check(err <= 1e-4, f"7c: scores off the exact products by {err:.3g}")

    # recall@10 of semantic search through the store, clustered queries
    qv = corpus.rows(32)
    rows = []
    for q in qv.cpu().numpy():
        r = st.similarity_search_by_vector_with_score(q, k=10)
        rows.append(np.asarray([idx._id_rows[d.metadata["chunk_id"]][0]
                                for d, _s in r]))
    n = idx.n_rows
    plane = torch.from_numpy(np.array(idx.store._buf[:n]).view(np.int16)) \
        .to(DEV).view(torch.bfloat16)
    exact = exact_top10(plane, n, qv)
    del plane
    out["recall_at_10"] = recall_at_10(rows, exact)
    check(out["recall_at_10"] >= 0.9,
          f"7c: recall@10 {out['recall_at_10']:.3f} < 0.9")

    # save/load round trip of the index
    path = os.path.join(xl_dir, "ckpt", "index.npz")
    before = idx.search(qv, k=10)
    t0 = time.perf_counter()
    idx.save(path)
    loaded = XlPQIndex.load(path, device=DEV)
    after = loaded.search(qv, k=10)
    out["save_load_s"] = time.perf_counter() - t0
    check(after[0] == before[0] and np.abs(after[1] - before[1]).max() <= 1e-6,
          "7c: the save/load round trip changed the results")
    del loaded
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7c", launches, routes,
                 ("fused_topk", "encoder_attention", "adc_scores_lut16"))
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7c: top-k fell back")
    out.update(requests=len(got), qps_micro_batched=len(got) / wall,
               **latency_ms(lat))
    results["service"]["xl"] = out
    log("  7c: " + json.dumps(out))
    st._batcher.close()
    return {"service_xl": (launches, routes)}


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
    ptxas = {name: kernel_resources(out)
             for name, out in sorted(_build.BUILD_LOGS.items())}
    for name, kernels in ptxas.items():
        log(f"  {name}:")
        for kernel, use in kernels.items():
            log(f"    {kernel}: {use}")
    log(f"  built {_build.sources()} in {secs:.1f} s")

    log("phase 2: kernels against their plain versions")
    results: dict = {"card": card, "build_s": secs, "ptxas": ptxas}
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
        topk_case("topk_b256_int8", 256, N_ROWS, N_ROWS, torch.int8, False,
                  timed=True),
        # wider rows, a ragged edge and k = 128 on the tensor-core route
        topk_case("topk_b33_k128_d768_bf16", 33, 300_007, 299_000, bf16, True,
                  k=128, d=768),
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
        attention_case("attn_b64_s200_hd64_bf16", 64, 200, torch.bfloat16,
                       nh=6, hd=64),
        attention_case("attn_b256_s128_f32", 256, 128, torch.float32,
                       timed=True),
        attention_case("attn_b256_s512_f32", 256, 512, torch.float32),
    ]
    adc8 = [
        # path A: cell probing, one query a group (G=1) over 64 cells of up
        # to 11 blocks of 512 (the snapshot's max_bpc at seed 0); a group
        # of 4; adc_topk's G = batch
        adc_case("adc8_g1_m48_s360448", 48, 1, 64 * 11 * 512, False,
                 timed=True),
        adc_case("adc8_g4_m48_s131072", 48, 4, 1 << 17, False),
        adc_case("adc8_g256_m48_s65536", 48, 256, 1 << 16, False),
        adc_case("adc8_g32_m96_s100003_k100", 96, 32, 100_003, False,
                 ksub=100),
    ]
    adc4 = [
        # path B: block probing, groups of 2 over 2 x 128 blocks of 512
        adc_case("adc4_g2_m48_s131072", 48, 2, 1 << 17, True, timed=True),
        adc_case("adc4_g1_m48_s999999", 48, 1, 999_999, True),
        adc_case("adc4_g256_m96_s4097", 96, 256, 4097, True),
    ]
    results["topk"], results["attention"] = topk, attn
    results["adc_scores"], results["adc_scores_lut16"] = adc8, adc4
    torch.cuda.empty_cache()

    log("phase 3: main path (MiniLM-L6 TorchEmbedder -> TorchVectorStore)")
    launches, store, emb, hybrid_q, docs, vocab = main_path(results)

    log("phase 4: timings")
    timings(results, store, emb, hybrid_q, docs)
    log("phase 7 inputs: phase 3's encoder and store written to disk")
    write_service_checkpoint(results, store, emb)
    del store
    torch.cuda.empty_cache()

    log("phase 5: path A, type: ivfpq (AnnFlatIndex over TorchVectorStore)")
    launches_a, store_a, corpus, _q, _exact = path_a(results, emb, docs, vocab)

    log("phase 6: path B, the XL tier's packed 4-bit snapshot")
    launches_b = path_b(results, store_a.index, corpus)
    del store_a, corpus, _q, _exact
    torch.cuda.empty_cache()

    log("phase 7: the service layer (bootstrap, micro-batching, hot tail, "
        "XL, rerank)")
    try:
        parts = service_flat(results, docs, vocab)
        parts.update(service_hot_tail(results, docs, vocab))
        parts.update(service_xl(results, vocab))
    finally:
        shutil.rmtree(SERVICE_TMP, ignore_errors=True)
    # each path and part ran with the counts set to 0 just before it
    results["launches"] = {"main": launches, "path_a": launches_a,
                           "path_b": launches_b}
    for part, (part_launches, part_routes) in parts.items():
        results["launches"][part] = part_launches
        results["routes"][part] = part_routes
    launches = {name: sum(p[name] for p in results["launches"].values())
                for name in launches}
    results["seconds"] = time.perf_counter() - t_start
    log("detail " + json.dumps(results))

    def entry(name, source, replaces, headline, cases):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(c["max_abs_err"] for c in cases),
               "ms": headline["ms"], "plain_ms": headline["plain_ms"],
               "bound_ms": headline["bound_ms"],
               "bound_by": headline["bound_by"],
               "library_ms": headline["library_ms"]}
        for key in ("ms_warm", "ms_cold"):    # the ADC kernels' L2 states
            if key in headline:
                out[key] = headline[key]
        # which kernel of the wrapper ran (main path, paths A and B)
        by_route = {key.split(":")[1]: sum(r[key] for r in
                                           results["routes"].values())
                    for key in results["routes"]["main"]
                    if key.startswith(name + ":")}
        if by_route:
            out["routes"] = by_route
        return out

    kernels = [
        entry("fused_topk", "archi_tpu_torch/csrc/fused_topk.cu",
              "archi_tpu/ops/pallas_topk.py:261", topk[0], topk),
        entry("encoder_attention", "archi_tpu_torch/csrc/encoder_attention.cu",
              "archi_tpu/ops/pallas_attention.py:97", attn[0], attn),
        entry("adc_scores", "archi_tpu_torch/csrc/adc.cu",
              "archi_tpu/ops/pallas_adc.py:58", adc8[0], adc8),
        entry("adc_scores_lut16", "archi_tpu_torch/csrc/adc.cu",
              "archi_tpu/ops/pallas_adc.py:112", adc4[0], adc4),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
