#!/usr/bin/env python3
"""Cross-shard merge overhead at a fixed corpus size, on the PyTorch/CUDA
port.

Counterpart of ``scripts/bench_shard_scaling.py``.  Fixed total rows
(default 2^20 x 384) on 1 / 2 / 4 / 8 logical shards of one device, two
tiers:

- ``ShardedFlatIndex``: the full search against a scan-only search (the
  same per-shard ``fused_topk`` calls, no merge); the difference is the
  merge, whose logical traffic is ``S * B * k * 8`` bytes (f32 values +
  i32 rows);
- ``ShardedXlPQIndex``: the per-phase wall times of ``search(profile=...)``
  (dispatch / fetch / host rerank / merge) and the fetched bytes.

The JAX script runs on an 8-device virtual CPU mesh; here the shards are
logical shards of one device (``--device cpu`` stands for that mesh, the
default is the card).  Shards of one device serialise, so the signal is
the merge column against the shard count, not absolute QPS.

Usage (from the root of the repository):

    python3 scripts/torch_bench_shard_scaling.py [OUT.json] [--rows N]
        [--skip-xl] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

B, K, TRIALS, NQ = 32, 10, 5, 8
SHARD_COUNTS = (1, 2, 4, 8)


def scan_only(idx, queries, k: int = K):
    """The per-shard half of ``ShardedFlatIndex.search_dispatch`` with no
    merge: each shard's local top-k over its live rows → per shard (vals
    [B, k], global rows [B, k] int64), left on its device."""
    import torch

    from archi_tpu_torch.engine.flat_index import l2_normalize
    from archi_tpu_torch.engine.topk import alive_to_bias, topk_scores

    q = torch.as_tensor(queries).to(idx.device, torch.float32)
    if idx.normalize:
        q = l2_normalize(q)
    with idx._buf_lock:
        embs, alives = idx._embs, idx._alives
        sc, n_rows = idx.shard_cap, idx.n_rows
    out = []
    for j, (emb, alive) in enumerate(zip(embs, alives)):
        lo = (idx.first_shard + j) * sc
        active = max(0, min(n_rows - lo, sc))
        v, r = topk_scores(q.to(emb.device), emb, alive_to_bias(alive),
                           active, k=k)
        out.append((v, r.to(torch.int64) + lo))
    return out


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _unit_rows(rng, n: int) -> np.ndarray:
    v = rng.standard_normal((n, 384), np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def bench_flat(n_total: int, devices, rng):
    """→ (the JAX script's row, the index)."""
    from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex

    s = len(devices)
    idx = ShardedFlatIndex(384, devices=devices, normalize=False)
    chunk = 1 << 17
    for i0 in range(0, n_total, chunk):
        n = min(chunk, n_total - i0)
        idx.add(_unit_rows(rng, n), list(range(i0, i0 + n)))
    dev = idx.device

    def qbatch():
        return _unit_rows(rng, B)

    # warm both paths
    idx.search_dispatch(qbatch(), k=K)[0].cpu()
    scan_only(idx, qbatch())[-1][0].cpu()

    def timed(fn):
        best = float("inf")
        for _ in range(TRIALS):
            qs = [qbatch() for _ in range(NQ)]
            t0 = time.perf_counter()
            for q in qs:
                fn(q)
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / NQ)
        return best

    full_s = timed(lambda q: idx.search_dispatch(q, k=K))
    scan_s = timed(lambda q: scan_only(idx, q))
    row = {
        "shards": s,
        "rows": n_total,
        "full_ms_per_batch32": round(full_s * 1e3, 2),
        "scan_only_ms_per_batch32": round(scan_s * 1e3, 2),
        "merge_overhead_ms": round((full_s - scan_s) * 1e3, 2),
        "collective_bytes_per_batch": s * B * K * 8,
        "query_qps": round(B / full_s, 1),
    }
    return row, idx


def bench_xl(n_total: int, devices, rng):
    """→ (the JAX script's row, the index)."""
    from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex

    s = len(devices)
    idx = ShardedXlPQIndex(
        384, devices=devices, normalize=False, nlist=256,
        min_snapshot_rows=1 << 16, build_block_rows=1 << 17)
    chunk = 1 << 17
    t_build0 = time.perf_counter()
    for i0 in range(0, n_total, chunk):
        n = min(chunk, n_total - i0)
        idx.add(_unit_rows(rng, n), list(range(i0, i0 + n)))
    idx.refresh_snapshots()
    build_s = time.perf_counter() - t_build0

    def qbatch():
        return _unit_rows(rng, B)

    idx.search(qbatch(), k=K)  # warm
    best = None
    for _ in range(TRIALS):
        prof: dict = {}
        t0 = time.perf_counter()
        idx.search(qbatch(), k=K, profile=prof)
        prof["total_s"] = time.perf_counter() - t0
        if best is None or prof["total_s"] < best["total_s"]:
            best = prof
    snap_rows = sum(ix._n_snap for ix in idx.shards)
    row = {
        "shards": s,
        "rows": n_total,
        "snapshot_rows": int(snap_rows),
        "build_s": round(build_s, 1),
        "dispatch_ms": round(best["dispatch_s"] * 1e3, 2),
        "fetch_ms": round(best["fetch_s"] * 1e3, 2),
        "rerank_ms": round(best["rerank_s"] * 1e3, 2),
        "merge_ms": round(best["merge_s"] * 1e3, 2),
        "fetch_bytes_per_batch": best["fetch_bytes"],
        "ms_per_batch32": round(best["total_s"] * 1e3, 2),
        "query_qps": round(B / best["total_s"], 1),
    }
    return row, idx


def measure(out_path=None, *, rows: int = 1 << 20, skip_xl: bool = False,
            device=None, keep=None, log=print):
    """Both tiers at every shard count → the JAX script's payload.
    ``device``: the card unless ``"cpu"``; the shards are logical shards
    of it.  ``keep(kind, shards, index)``, when given, sees each index
    before it is dropped (a caller's own checks)."""
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    rng = np.random.default_rng(11)
    flat_rows, xl_rows = [], []
    for s in SHARD_COUNTS:
        row, idx = bench_flat(rows, [dev] * s, rng)
        log("flat " + json.dumps(row))
        flat_rows.append(row)
        if keep is not None:
            keep("flat", s, idx)
        del idx
    if not skip_xl:
        for s in SHARD_COUNTS:
            row, idx = bench_xl(rows, [dev] * s, rng)
            log("xl " + json.dumps(row))
            xl_rows.append(row)
            if keep is not None:
                keep("xl", s, idx)
            del idx
    payload = {
        "setup": (
            f"fixed total rows = {rows}, dim 384, {max(SHARD_COUNTS)} "
            f"logical shards of one {dev.type} device at most (per-shard "
            "scans serialise on it; the measurement is the merge columns "
            "against the shard count, and that they stay bytes-sized)"),
        "batch": B, "k": K, "trials": TRIALS,
        "sharded_flat": flat_rows,
        "sharded_xl": xl_rows,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    return payload


def main() -> None:
    args = sys.argv[1:]
    out_path = args[0] if args and not args[0].startswith("-") \
        else "shard_scaling_torch.json"
    n_total = int(args[args.index("--rows") + 1]) if "--rows" in args \
        else 1 << 20
    device = args[args.index("--device") + 1] if "--device" in args \
        else None
    measure(out_path, rows=n_total, skip_xl="--skip-xl" in args,
            device=device, log=lambda msg: print(msg, flush=True))
    print("wrote", out_path)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
