#!/usr/bin/env python3
"""BASELINE config 4 — synthetic chunks, IVF-PQ with refinement, recall/QPS
sweep, with the host exact-rerank tier closing strict recall — on the
PyTorch/CUDA port.

Counterpart of ``scripts/run_config4.py``, with its protocol, flags and
payload keys.  IVF-PQ with a refinement stage
(``archi_tpu_torch.engine.ivfpq_index``) holds the corpus as packed 4-bit
codes (m = 96 + 96, 96 B a row); the corpus itself is never whole on the
card: blocks are generated (``benchmarking.synth_corpus``), coarse-assigned
and residual-encoded in a streaming build.  The same rows live host-side in
a bf16 memmap (``scripts/torch_fill_host_store.py``), and
``IVFPQIndex.search(rerank_store=...)`` re-scores the card's top-C ADC
candidates exactly.

Ground truth is exact: queries are noisy copies of stored rows, and the
exact top-10 comes from an f32 streaming scan through the fused top-k
kernel over regenerated blocks, merged across blocks.  QPS is best of 3 x 8
unchained disjoint batches, synchronised with ``torch.cuda.synchronize``,
minus ``benchmarking.timing.measure_relay_rtt`` (on the card, its
sync-and-copy round trip; the JAX key ``relay_rtt_ms`` is kept).

Departure from the JAX script: with ``--gt-cache`` it names an undefined
``rng`` at its first timing; here the timing draws come from the query
seed's generator in both modes.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_run_config4.py [out.json] [--rows N] [--quick]
        [--store PATH] [--no-rerank] [--wait-store] [--gt-only]
        [--gt-cache PATH] [--gt-bf16] [--index PATH] [--nlist 16384]
        [--block 512] [--spill 0.15] [--opq 4] [--sub S] [--drop-refine]
        [--bc-dtype f32] [--no-adc] [--dev-sweep npr:C[:rfo],...]
        [--rerank-sweep npb:C[:rfo[:gate]],cell:npr:C[:rfo],...]
        [--exact-extract | --extract MODE] [--hier-t T] [--rtt MS]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

B, K = 32, 10
DEFAULT_STORE = os.path.join(tempfile.gettempdir(), "archi_host_store",
                             "config4.bf16")
NPROBES = (4, 8, 16, 32)
#: a timing's batches and trials (best of TRIALS x REPS)
REPS, TRIALS = 8, 3
#: the JAX script's host-rerank sweep: (mode, probe, C, rfo, gate)
RERANK_SWEEP = [("npb", 128, 160, 1, 0), ("npb", 128, 320, 1, 0),
                ("npb", 256, 320, 1, 0), ("npb", 384, 320, 1, 0),
                ("npb", 512, 320, 1, 0), ("npb", 512, 640, 1, 0)]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure_qps(search_fn, q, rng, *, rtt_s: float, device,
                 sync=None) -> float:
    """Best-of-``TRIALS`` mean seconds a batch over unchained disjoint
    query batches (inputs staged on the device beforehand)."""
    import torch

    reps, trials = REPS, TRIALS
    qvars = []
    for _ in range(trials * reps):
        qv = q + 0.01 * rng.standard_normal(q.shape).astype(np.float32)
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        qvars.append(torch.as_tensor(qv, device=device))
    _sync(device)
    best = float("inf")
    for t in range(trials):
        batch = qvars[t * reps:(t + 1) * reps]
        t0 = time.perf_counter()
        out = None
        for qv in batch:
            out = search_fn(qv)
        if sync is not None:
            sync(out)
        best = min(best, max((time.perf_counter() - t0 - rtt_s) / reps,
                             1e-9))
    return best


def parse_rerank_sweep(text: str) -> list:
    """``npb:C[:rfo[:gate]]`` (block-budget probing, rfo 1, gate 0 =
    ungated) or ``cell:nprobe:C[:rfo]`` (cell probing, rfo 8), comma
    separated → (mode, probe, C, rfo, gate) tuples."""
    out = []
    for pair in text.split(","):
        v = pair.split(":")
        if v[0] == "cell":
            out.append(("cell", int(v[1]), int(v[2]),
                        int(v[3]) if len(v) > 3 else 8, 0))
        else:
            out.append(("npb", int(v[0]), int(v[1]),
                        int(v[2]) if len(v) > 2 else 1,
                        int(v[3]) if len(v) > 3 else 0))
    return out


def parse_dev_sweep(text: str) -> list:
    """``nprobe:C[:rfo]`` triples (rfo 8), comma separated."""
    out = []
    for trip in text.split(","):
        v = [int(x) for x in trip.split(":")]
        out.append((v[0], v[1], v[2] if len(v) > 2 else 8))
    return out


def headline_of(sweep: list, rerank_sweep: list) -> dict:
    """The fastest rerank entry with tie-aware score recall >= 0.99 (the
    metric that ignores sub-f32-reproducibility k-boundary ties); else
    strict >= 0.95; else the ADC-only sweep's fastest entry with self_top1
    >= 0.7 (or its best self_top1); else the best rerank entry."""
    good = [s for s in rerank_sweep
            if (s.get("recall_score_at_10") or 0) >= 0.99]
    if not good:
        good = [s for s in rerank_sweep if s["recall_strict_at_10"] >= 0.95]
    if good:
        best_cfg = max(good, key=lambda s: s["query_qps"])
        return {"query_qps": best_cfg["query_qps"],
                "recall_strict_at_10": best_cfg["recall_strict_at_10"],
                **({"recall_score_at_10": best_cfg["recall_score_at_10"]}
                   if best_cfg.get("recall_score_at_10") is not None
                   else {}),
                "probe": best_cfg.get("nprobe_blocks",
                                      best_cfg.get("nprobe")),
                "probe_mode": best_cfg.get("probe_mode", "cell"),
                "rerank_c": best_cfg["rerank_c"]}
    if sweep:
        gg = [s for s in sweep if s["self_top1"] >= 0.7]
        bc = (max(gg, key=lambda s: s["query_qps"]) if gg
              else max(sweep, key=lambda s: s["self_top1"]))
        return {"query_qps": bc["query_qps"],
                "self_top1": bc["self_top1"], "nprobe": bc["nprobe"]}
    if rerank_sweep:
        bc = max(rerank_sweep, key=lambda s: s["recall_strict_at_10"])
        return {"query_qps": bc["query_qps"],
                "recall_strict_at_10": bc["recall_strict_at_10"],
                "nprobe": bc["nprobe"], "rerank_c": bc["rerank_c"]}
    return {}


def measure(out_path=None, *, rows=None, quick: bool = False,
            store_path: str = DEFAULT_STORE, no_rerank: bool = False,
            wait_store: bool = False, gt_cache=None, gt_only: bool = False,
            gt_bf16: bool = False, index_path=None, nlist: int = 16384,
            block: int = 512, spill: float = 0.0, opq: int = 0, sub=None,
            drop_refine: bool = False, bc_dtype: str = "bf16",
            no_adc: bool = False, dev_sweep=None, rerank_sweep=None,
            extract: str = "auto", hier_t: int = 64, rtt_ms=None,
            block_rows=None, device=None, log=print):
    """The whole protocol → ``(payload, state)``: the JAX script's payload
    (None with ``gt_only``, which saves the GT cache instead) and what a
    caller checks it with (``index``, ``store``, ``q``, ``q_src``,
    ``exact`` and ``exact_vals``, ``block_fn``, ``rows``, ``rerank_out``:
    each rerank entry's (vals, rows)).  ``device``: the card unless
    ``"cpu"``; ``block_rows`` cuts the blocks for a dry run (default
    ``synth_corpus.BLOCK_ROWS``); ``rerank_sweep`` / ``dev_sweep`` take the
    JAX flags' specs (strings) or parsed tuples."""
    import torch

    from archi_tpu_torch.benchmarking.synth_corpus import (BLOCK_ROWS, D,
                                                           make_block_fn)
    from archi_tpu_torch.benchmarking.timing import measure_relay_rtt
    from archi_tpu_torch.engine.host_store import (BF16, HostVectorStore,
                                                   bf16_bits_to_f32)
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from archi_tpu_torch.engine.topk import topk_lower_first, topk_scores
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    block_rows = BLOCK_ROWS if block_rows is None else int(block_rows)
    n_blocks = (8 if quick else 96) if rows is None \
        else max(1, int(rows) // block_rows)
    n = n_blocks * block_rows
    block_fn = make_block_fn(0, n_blocks, block_rows=block_rows, device=dev)
    have_gt = bool(gt_cache) and not gt_only and os.path.exists(gt_cache)

    def fetch_rows(row_ids):
        """[len(row_ids), D] bf16 bits of regenerated rows, one gather a
        distinct block."""
        out = np.empty((len(row_ids), D), np.uint16)
        by_block: dict[int, list[tuple[int, int]]] = {}
        for j, rr in enumerate(row_ids):
            by_block.setdefault(int(rr // block_rows), []).append(
                (j, int(rr % block_rows)))
        for bi, pairs in by_block.items():
            ii = torch.as_tensor([r for _j, r in pairs], device=dev)
            got = block_fn(bi)[ii].view(torch.int16).cpu().numpy()
            out[[j for j, _r in pairs]] = got.view(np.uint16)
        return out

    def open_store():
        """Open and verify the host tier (filled by
        torch_fill_host_store.py); after the build, as in the JAX
        script."""
        if no_rerank or not os.path.exists(store_path):
            return None
        if wait_store:
            deadline = time.time() + 2 * 3600
            while time.time() < deadline:
                try:
                    n_now = len(HostVectorStore(D, path=store_path,
                                                capacity=n, dtype=BF16))
                except Exception:  # torn meta.json mid-write
                    n_now = -1
                if n_now >= n:
                    break
                log(f"waiting for host store fill: {n_now}/{n} rows")
                time.sleep(120)
        store = HostVectorStore(D, path=store_path, capacity=n, dtype=BF16)
        if len(store) != n:
            # the generator is parameterised by the block count
            # (n_clusters = N/64): a store filled for another N holds
            # other rows, not a prefix
            log(f"host store has {len(store)} rows, run needs {n} — run "
                f"torch_fill_host_store.py for this size; continuing "
                f"ADC-only")
            return None
        if have_gt:
            log("host tier identity attested at GT-cache build")
            return store
        probe = np.array([0, 1, n // 3, n // 2, n - 1])
        assert np.array_equal(fetch_rows(probe),
                              np.asarray(store._buf[probe])), \
            "host store rows != device corpus rows (stale fill?)"
        log("host tier verified bit-identical on sample rows")
        return store

    # --- build (streamed; only codes stay resident), or reload
    t0 = time.time()
    idx, build_s, code_gb = None, 0.0, 0.0
    saved = index_path and (os.path.exists(index_path)
                            or os.path.exists(index_path + ".npz"))
    if gt_only:
        pass
    elif saved:
        idx = IVFPQIndex.load(index_path, drop_refine=drop_refine,
                              device=dev)
        log(f"loaded index from {index_path}")
    else:
        idx = IVFPQIndex.build_streaming(
            block_fn, n_blocks, block_rows,
            nlist=nlist, block=block, m=96, ksub=16, refine_m=96,
            train_blocks=2, train_sample=1 << 21, coarse_iters=8,
            pq_iters=10, seed=0, spill_frac=spill, opq_iters=opq,
            device=dev)
    if idx is not None:
        t_bc = time.time()
        if sub is not None:
            idx.block_rank_sub = int(sub)
        if drop_refine:
            # with refine_overfetch=1 and the exact host rerank the refine
            # stage only reorders the candidates the host rescores
            idx.refine_codec = None
            idx.refine_codes = None
        idx.ensure_block_centroids(
            dtype=torch.float32 if bc_dtype == "f32" else torch.bfloat16)
        _sync(dev)
        log(f"block centroids: {time.time() - t_bc:.1f}s "
            f"(n_blocks={idx.code_blocks.shape[0]}, "
            f"max_bpc={idx.cell_blocks.shape[1]})")
        if index_path and not saved:
            try:
                idx.save(index_path)
                log(f"saved index to {index_path}")
            except Exception as e:
                log(f"index save FAILED ({type(e).__name__}: "
                    f"{str(e)[:160]}) — continuing to sweep without an "
                    f"on-disk index")
        build_s = time.time() - t0
        code_gb = (idx.code_blocks.numel()
                   + (idx.refine_codes.numel()
                      if idx.refine_codes is not None else 0)) / 1e9
        log(f"built {n} rows in {build_s:.1f}s; codes {code_gb:.2f} GB "
            f"(corpus would be {n * D * 2 / 1e9:.1f} GB)")

    store = open_store()

    rng = np.random.default_rng(1)
    exact_vals = None
    if have_gt:
        gtc = np.load(gt_cache)
        q, q_src, exact = gtc["q"], gtc["q_src"], gtc["exact"]
        assert q.shape == (B, D) and exact.shape == (B, K), \
            "GT cache shape mismatch — rebuild with --gt-only"
        exact_s = 0.0
        log(f"loaded queries + exact GT from {gt_cache}")
    else:
        # --- queries: noisy copies of known rows
        q_src = np.sort(rng.choice(n, B, replace=False))
        q = bf16_bits_to_f32(fetch_rows(q_src))
        q = q + 0.03 * rng.standard_normal(q.shape).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    qd = torch.as_tensor(q, device=dev)

    # --- exact ground truth: streaming fused scan over regenerated blocks,
    # f32 by default (blocks upcast: the host rerank's scorer); --gt-bf16
    # scans the bf16 blocks
    if not have_gt:
        t0 = time.time()
        parts_v, parts_r = [], []
        zero_bias = torch.zeros((block_rows,), dtype=torch.float32,
                                device=dev)
        for i in range(n_blocks):
            blk_i = block_fn(i)
            if not gt_bf16:
                blk_i = blk_i.float()
            v, r = topk_scores(qd, blk_i, zero_bias, block_rows, k=K)
            parts_v.append(v)
            parts_r.append(r.long() + i * block_rows)
            del blk_i
        mv, mp = topk_lower_first(torch.cat(parts_v, 1), K)
        exact = torch.gather(torch.cat(parts_r, 1), 1, mp).cpu().numpy()
        exact_vals = mv.cpu().numpy()
        exact_s = time.time() - t0
        log(f"exact GT scan: {exact_s:.1f}s")

    state = {"index": idx, "store": store, "q": q, "q_src": q_src,
             "exact": exact, "exact_vals": exact_vals, "block_fn": block_fn,
             "rows": n, "rerank_out": []}
    if gt_only:
        assert gt_cache, "--gt-only needs --gt-cache PATH"
        np.savez(gt_cache, q=q, q_src=q_src, exact=exact)
        log(f"GT cache saved to {gt_cache}")
        return None, state

    r = (float(rtt_ms) / 1e3 if rtt_ms is not None
         else measure_relay_rtt(device=dev))

    def strict_of(rows_h):
        return float(np.mean([
            len(set(rows_h[b]) & set(exact[b])) / K for b in range(B)]))

    # --- score-based recall@10 (the JAX script's): a returned row counts
    # if the host rows score it >= the 10th-best ground-truth score, in
    # f64 with a 1e-9 tie slack
    gt_tau = None
    q64 = q.astype(np.float64)
    if store is not None:
        gt_tau = np.empty(B, np.float64)
        for b in range(B):
            g = np.asarray(store.get(exact[b]), np.float64)
            gt_tau[b] = float(np.min(g @ q64[b]))

    def score_recall_of(rows_h):
        if gt_tau is None:
            return None
        hits = 0
        for b in range(B):
            rb = np.unique(np.asarray(rows_h[b], np.int64))
            g = np.asarray(store.get(rb), np.float64)
            hits += min(K, int(np.sum(g @ q64[b] >= gt_tau[b] - 1e-9)))
        return hits / (B * K)

    def sync_dev(_out):
        _sync(dev)

    # --- ADC-only nprobe sweep (quantization-bound recall)
    sweep = []
    for nprobe in () if no_adc else NPROBES:
        _vals, rows_d = idx.search_dispatch(qd, k=K, nprobe=nprobe,
                                            refine_overfetch=16)
        rows_h = rows_d.cpu().numpy()
        strict = strict_of(rows_h)
        top1 = float(np.mean(rows_h[:, 0] == q_src))
        _, r100d = idx.search_dispatch(qd, k=100, nprobe=nprobe,
                                       refine_overfetch=16)
        r100 = r100d.cpu().numpy()
        in100 = float(np.mean([len(set(r100[b]) & set(exact[b])) / K
                               for b in range(B)]))

        def dev_search(qv, nprobe=nprobe):
            v, _ = idx.search_dispatch(qv, k=K, nprobe=nprobe,
                                       refine_overfetch=16)
            return v

        best = _measure_qps(dev_search, q, rng, rtt_s=r, device=dev,
                            sync=sync_dev)
        sweep.append({
            "nprobe": nprobe,
            "recall_strict_at_10": round(strict, 3),
            "recall_at_10_in_100": round(in100, 3),
            "self_top1": round(top1, 3),
            "ms_per_batch32": round(best * 1e3, 1),
            "query_qps": round(B / best, 1),
        })
        log(json.dumps(sweep[-1]))

    # --- device-only candidate sweep: nprobe x C x refine_overfetch (strict
    # recall after an exact rerank equals candidate recall)
    dev_rows = []
    if isinstance(dev_sweep, str):
        dev_sweep = parse_dev_sweep(dev_sweep)
    for nprobe, c, rfo in dev_sweep or ():
        _, rows_d = idx.search_dispatch(qd, k=c, nprobe=nprobe,
                                        refine_overfetch=rfo)
        rows_h = rows_d.cpu().numpy()
        cand = float(np.mean([len(set(rows_h[b]) & set(exact[b])) / K
                              for b in range(B)]))
        top1 = float(np.mean(rows_h[:, 0] == q_src))

        def dev_only(qv, nprobe=nprobe, c=c, rfo=rfo):
            v, _ = idx.search_dispatch(qv, k=c, nprobe=nprobe,
                                       refine_overfetch=rfo)
            return v

        best = _measure_qps(dev_only, q, rng, rtt_s=r, device=dev,
                            sync=sync_dev)
        dev_rows.append({
            "nprobe": nprobe, "rerank_c": c, "refine_overfetch": rfo,
            "recall_strict_at_10_after_exact_rerank": round(cand, 3),
            "self_top1_stage": round(top1, 3),
            "dev_ms_per_batch32": round(best * 1e3, 1),
            "dev_qps": round(B / best, 1),
        })
        log(json.dumps(dev_rows[-1]))

    # --- host-rerank sweep: probe x rerank-C (candidate-bound recall)
    rerank_rows = []
    if store is not None:
        # warm the page cache: one sequential pass over the memmap
        t0 = time.time()
        buf = store._buf
        s = 0
        for ofs in range(0, buf.shape[0], 1 << 21):
            s += int(np.asarray(buf[ofs:ofs + (1 << 21), 0]).sum())
        log(f"page-cache warm pass: {time.time() - t0:.1f}s")
        if rerank_sweep is None:
            rerank_sweep = RERANK_SWEEP
        elif isinstance(rerank_sweep, str):
            rerank_sweep = parse_rerank_sweep(rerank_sweep)
        for mode, probe, c, rfo, gate in rerank_sweep:
            overfetch = max(1, c // K)
            skw = ({"nprobe_blocks": probe} if mode == "npb"
                   else {"nprobe": probe})
            if gate:
                skw["cell_gate"] = gate
            _ids, vals, rows_h = idx.search(
                qd, k=K, rerank_store=store, rerank_overfetch=overfetch,
                refine_overfetch=rfo, extract=extract, hier_t=hier_t, **skw)
            state["rerank_out"].append((vals, rows_h))
            strict = strict_of(rows_h)
            top1 = float(np.mean(rows_h[:, 0] == q_src))

            def rr_search(qv, overfetch=overfetch, rfo=rfo, skw=skw):
                _, v, _ = idx.search(qv, k=K, rerank_store=store,
                                     rerank_overfetch=overfetch,
                                     refine_overfetch=rfo, extract=extract,
                                     hier_t=hier_t, **skw)
                return v

            # search() returns host arrays: it has synchronised
            best = _measure_qps(rr_search, q, rng, rtt_s=r, device=dev)

            def dev_only(qv, overfetch=overfetch, rfo=rfo, skw=skw):
                v, _ = idx.search_dispatch(
                    qv, k=K * overfetch, refine_overfetch=rfo,
                    extract=extract, hier_t=hier_t, **skw)
                return v

            dev_best = _measure_qps(dev_only, q, rng, rtt_s=r, device=dev,
                                    sync=sync_dev)
            rerank_rows.append({
                "probe_mode": mode,
                ("nprobe_blocks" if mode == "npb" else "nprobe"): probe,
                "rerank_c": int(c),
                "refine_overfetch": int(rfo),
                **({"cell_gate": int(gate)} if gate else {}),
                "recall_strict_at_10": round(strict, 3),
                "recall_score_at_10": round(score_recall_of(rows_h), 4),
                "self_top1": round(top1, 3),
                "ms_per_batch32": round(best * 1e3, 1),
                "query_qps": round(B / best, 1),
                "rerank_cost_ms": round((best - dev_best) * 1e3, 1),
            })
            log(json.dumps(rerank_rows[-1]))

    payload = {
        "config": f"BASELINE config 4 on one card (PyTorch/CUDA port): "
                  f"{n}-chunk IVF-PQ with refinement (4-bit LUT16, "
                  f"m=96+96 packed = 96 B/row, "
                  f"nlist={nlist}, block={block}, block-budget probing by "
                  f"per-block mini-centroids) + host bf16 exact-rerank tier "
                  f"({n * D * 2 / 1e9:.1f} GB memmap) — codes "
                  f"{code_gb:.2f} GB on the card",
        "rows": int(n), "dim": D,
        "build": {"nlist": nlist, "block": block, "spill_frac": spill,
                  "opq_iters": opq},
        "corpus_equiv_gb": round(n * D * 2 / 1e9, 1),
        "codes_gb": round(code_gb, 2),
        "build_s": round(build_s, 1),
        "gt_scoring": "bf16-dot (legacy)" if gt_bf16 else
                      "f32 over stored-bf16 values (matches the exact host "
                      "rerank's scorer)",
        "exact_gt_scan_s": round(exact_s, 1),
        "relay_rtt_ms": round(r * 1e3, 4),
        "nprobe_sweep": sweep,
        "dev_sweep": dev_rows,
        "rerank_sweep": rerank_rows,
        "host_store": None if store is None else {
            "path": store_path, "rows": len(store), "dtype": "bfloat16",
            "gb": round(len(store) * D * 2 / 1e9, 1),
            "verified": "bit-identical sample rows vs device corpus"},
        "metric_notes": "strict@10 at this cluster density (64 near-"
                        "duplicates/cluster) is bounded by the 4-bit ADC's "
                        "resolution on the device-only path; the "
                        "rerank_sweep closes it with exact host re-scoring "
                        "of the top-C (rerank_cost_ms = host gather + "
                        "rescore, measured).",
        "headline": headline_of(sweep, rerank_rows),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
    return payload, state


def run(out_path=None, **kw):
    """``measure`` → its payload (None with ``gt_only``), written to
    ``out_path`` when given."""
    return measure(out_path, **kw)[0]


def _flag(args, name, cast=str, default=None):
    return cast(args[args.index(name) + 1]) if name in args else default


def main() -> None:
    args = sys.argv[1:]
    out_path = args[0] if args and not args[0].startswith("-") \
        else "CONFIG4_torch.json"
    extract = "exact" if "--exact-extract" in args else "auto"
    payload = run(
        out_path, rows=_flag(args, "--rows", int), quick="--quick" in args,
        store_path=_flag(args, "--store", str, DEFAULT_STORE),
        no_rerank="--no-rerank" in args, wait_store="--wait-store" in args,
        gt_cache=_flag(args, "--gt-cache"), gt_only="--gt-only" in args,
        gt_bf16="--gt-bf16" in args, index_path=_flag(args, "--index"),
        nlist=_flag(args, "--nlist", int, 16384),
        block=_flag(args, "--block", int, 512),
        spill=_flag(args, "--spill", float, 0.0),
        opq=_flag(args, "--opq", int, 0), sub=_flag(args, "--sub", int),
        drop_refine="--drop-refine" in args,
        bc_dtype=_flag(args, "--bc-dtype", str, "bf16"),
        no_adc="--no-adc" in args, dev_sweep=_flag(args, "--dev-sweep"),
        rerank_sweep=_flag(args, "--rerank-sweep"),
        extract=_flag(args, "--extract", str, extract),
        hier_t=_flag(args, "--hier-t", int, 64),
        rtt_ms=_flag(args, "--rtt", float),
        log=lambda msg: print(msg, flush=True))
    if payload is not None:
        print(json.dumps(payload, indent=2))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
