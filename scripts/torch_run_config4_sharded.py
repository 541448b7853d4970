#!/usr/bin/env python3
"""BASELINE config 4 through the sharded XL serving tier, on the
PyTorch/CUDA port.

Counterpart of ``scripts/run_config4_sharded.py``: the config-4 corpus
served by ``ShardedXlPQIndex`` — per-shard host plane + IVF-PQ snapshot +
exact host rerank + global merge — instead of the single ``IVFPQIndex``
of ``scripts/torch_run_config4.py``.  One card plays all shards
(``devices=["cuda:0"] * S``: per-shard device work serialises, so QPS is a
lower bound on S cards; recall is what S cards would return, since
per-shard results are exact host-rescored products and the merge is a
global top-k).  The corpus plane is the one ``torch_fill_host_store.py``
filled, cut into zero-copy per-shard views (``HostVectorStore.view``) and
bulk-adopted (``adopt_stores``); each shard's snapshot streams regenerated
blocks (checked bit for bit against its plane) with the single-index
run's treatments (spill 0.15, OPQ 4).

Parity protocol: equal total probe budget (per-shard ``nprobe_blocks`` =
budget / S) and equal total exact-rerank candidates (per-shard overfetch =
320 / (k S)) against ``torch_run_config4``'s rerank rows.

Departure from the JAX script: it requires a plane filled for the full
96-block generator and uses its first rows.  The port takes the block count
the plane holds and regenerates with ``make_block_fn`` at that count, so a
plane filled at any size (a cut one included) serves.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_run_config4_sharded.py [out.json] [--shards 4]
        [--blocks-per-shard N] [--merge-into CONFIG4.json]
        [--store PATH] [--budgets 2048,4096,8192]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

B, K = 32, 10
BUDGETS = (2048, 4096, 8192)
#: a timing's batches and trials (best of TRIALS x REPS)
REPS, TRIALS = 6, 3


def measure(out_path=None, *, shards: int = 4, blocks_per_shard=None,
            store_path=None, budgets=BUDGETS, merge_into=None,
            nlist: int = 16384, block_rows=None, device=None, log=print):
    """Build the sharded tier over the plane, then the parity sweep →
    ``(payload, state)``: the JAX script's payload and what a caller checks
    it with (``index``, ``parent`` store, ``q``, ``q_src``, ``exact``,
    ``exact_vals``, ``searches``: each budget's (vals, rows)).
    ``device``: the card unless ``"cpu"``, repeated for the shards;
    ``nlist`` (the total, cut by the shard count) and ``block_rows`` (the
    fill's) cut the run for a dry run."""
    import torch

    from archi_tpu_torch.benchmarking.synth_corpus import (BLOCK_ROWS, D,
                                                           make_block_fn)
    from archi_tpu_torch.benchmarking.timing import measure_relay_rtt
    from archi_tpu_torch.engine.host_store import (BF16, HostVectorStore,
                                                   bf16_bits_to_f32)
    from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
    from archi_tpu_torch.engine.topk import topk_lower_first, topk_scores
    from archi_tpu_torch.utils.hardware import default_device
    from scripts.torch_run_config4 import DEFAULT_STORE

    dev = default_device(device)
    store_path = DEFAULT_STORE if store_path is None else store_path
    block_rows = BLOCK_ROWS if block_rows is None else int(block_rows)
    parent = HostVectorStore(D, path=store_path, capacity=block_rows,
                             dtype=BF16)
    total_blocks = len(parent) // block_rows
    bps = (total_blocks // shards if blocks_per_shard is None
           else int(blocks_per_shard))
    per_shard = bps * block_rows
    n = shards * per_shard
    assert 0 < n <= len(parent), (n, len(parent))
    # the generator at the block count the plane was filled with
    block_fn = make_block_fn(0, total_blocks, block_rows=block_rows,
                             device=dev)

    def bits(t):
        return t.view(torch.int16).cpu().numpy().view(np.uint16)

    views = [HostVectorStore.view(parent, s * per_shard, (s + 1) * per_shard)
             for s in range(shards)]
    t0 = time.time()
    # snapshot sources: each shard's plane is exactly bps generator blocks,
    # regenerated on the card instead of read back from the plane
    sources = [(lambda i, s=s: block_fn(s * bps + i)) for s in range(shards)]
    for s in sorted({0, shards - 1}):
        probe = np.array([0, per_shard // 2, per_shard - 1])
        got = np.stack([bits(block_fn(int((s * per_shard + r) // block_rows))
                             [int(r % block_rows)]) for r in probe])
        assert np.array_equal(got, np.asarray(views[s]._buf[probe])), \
            f"shard {s} plane rows != device-regenerated rows"
    log("snapshot sources verified bit-identical vs shard planes")
    idx = ShardedXlPQIndex(
        D, devices=[dev] * shards,
        stores=views, normalize=False, snapshot_sources=sources,
        nlist=nlist // shards, block=512, pq_m=96, pq_refine_m=96,
        ksub=16, pq_spill=0.15, pq_opq_iters=4,
        rerank_overfetch=max(1, 320 // (K * shards)),
        build_block_rows=block_rows, min_snapshot_rows=1 << 17)
    idx.adopt_stores([range(s * per_shard, (s + 1) * per_shard)
                      for s in range(shards)])
    build_s = time.time() - t0
    log(f"adopted+built {shards} shards x {per_shard} rows in "
        f"{build_s:.1f}s")

    # --- queries: noisy copies of stored rows (torch_run_config4's
    # protocol and seed stream)
    rng = np.random.default_rng(1)
    q_src = np.sort(rng.choice(n, B, replace=False))
    q = bf16_bits_to_f32(parent._buf[q_src])
    q = q + 0.03 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qd = torch.as_tensor(q, device=dev)

    # --- exact GT: f32 streaming scan over the first N rows' blocks
    t0 = time.time()
    parts_v, parts_r = [], []
    zero_bias = torch.zeros((block_rows,), dtype=torch.float32, device=dev)
    for i in range(n // block_rows):
        v, r = topk_scores(qd, block_fn(i).float(), zero_bias, block_rows,
                           k=K)
        parts_v.append(v)
        parts_r.append(r.long() + i * block_rows)
    mv, mp = topk_lower_first(torch.cat(parts_v, 1), K)
    exact = torch.gather(torch.cat(parts_r, 1), 1, mp).cpu().numpy()
    log(f"exact GT scan: {time.time() - t0:.1f}s")

    q64 = q.astype(np.float64)
    gt_tau = np.empty(B, np.float64)
    for b in range(B):
        g = parent.get(exact[b]).astype(np.float64)
        gt_tau[b] = float(np.min(g @ q64[b]))

    rtt = measure_relay_rtt(device=dev)
    sweep, searches = [], []
    for budget in budgets:
        per_probe = max(1, budget // shards)
        prof: dict = {}
        _ids, vals, rows = idx.search(q, k=K, nprobe_blocks=per_probe,
                                      profile=prof)
        searches.append((vals, rows))
        strict = float(np.mean([len(set(rows[b]) & set(exact[b])) / K
                                for b in range(B)]))
        hits = 0
        for b in range(B):
            rb = np.unique(np.asarray(rows[b], np.int64))
            g = parent.get(np.clip(rb, 0, len(parent) - 1)).astype(
                np.float64)
            hits += min(K, int(np.sum(g @ q64[b] >= gt_tau[b] - 1e-9)))
        score_rec = hits / (B * K)
        top1 = float(np.mean(rows[:, 0] == q_src))

        # QPS: unchained disjoint batches, the round trip subtracted once a
        # batch (the sharded search synchronises inside)
        best = float("inf")
        qvars = []
        for _ in range(TRIALS * REPS):
            qv = q + 0.01 * rng.standard_normal(q.shape).astype(np.float32)
            qv /= np.linalg.norm(qv, axis=1, keepdims=True)
            qvars.append(qv)
        for t in range(TRIALS):
            tt = time.time()
            for qv in qvars[t * REPS:(t + 1) * REPS]:
                idx.search(qv, k=K, nprobe_blocks=per_probe)
            best = min(best, max((time.time() - tt) / REPS - rtt, 1e-9))
        sweep.append({
            "total_probe_blocks": budget,
            "per_shard_probe_blocks": per_probe,
            "total_rerank_c": K * idx.shards[0].rerank_overfetch * shards,
            "recall_strict_at_10": round(strict, 3),
            "recall_score_at_10": round(score_rec, 4),
            "self_top1": round(top1, 3),
            "ms_per_batch32": round(best * 1e3, 1),
            "query_qps": round(B / best, 1),
            "phase_ms": {k2: round(v2 * 1e3, 1)
                         for k2, v2 in prof.items() if k2.endswith("_s")},
            "fetch_bytes_per_batch": prof.get("fetch_bytes"),
        })
        log(json.dumps(sweep[-1]))

    payload = {
        "config": f"BASELINE config 4 served through ShardedXlPQIndex: "
                  f"{shards} shards x {per_shard} rows on one card "
                  f"(devices=[{dev}]*{shards}; per-shard work serialises — "
                  f"QPS is a lower bound on {shards} cards; recall is "
                  f"theirs). Per-shard: zero-copy plane view + IVF-PQ "
                  f"snapshot (spill 0.15, OPQ 4, nlist={nlist // shards}) "
                  f"+ exact host rerank; global top-k merge.",
        "rows": int(n), "dim": D, "shards": shards,
        "build_s": round(build_s, 1),
        "relay_rtt_ms": round(rtt * 1e3, 4),
        "parity_protocol": "equal TOTAL probe budget (per-shard = "
                           "budget/S) and equal total exact-rerank "
                           "candidates (320) vs the single-index "
                           "rerank_sweep rows",
        "sweep": sweep,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
    if merge_into and os.path.exists(merge_into):
        with open(merge_into) as f:
            base = json.load(f)
        base["sharded_xl"] = payload
        with open(merge_into, "w") as f:
            json.dump(base, f, indent=2)
        log(f"merged into {merge_into} as 'sharded_xl'")
    state = {"index": idx, "parent": parent, "q": q, "q_src": q_src,
             "exact": exact, "exact_vals": mv.cpu().numpy(),
             "searches": searches}
    return payload, state


def run(out_path=None, **kw) -> dict:
    """``measure`` → its payload, written to ``out_path`` when given."""
    return measure(out_path, **kw)[0]


def main() -> None:
    args = sys.argv[1:]

    def flag(name, default=None):
        return args[args.index(name) + 1] if name in args else default

    out_path = args[0] if args and not args[0].startswith("-") \
        else "CONFIG4_sharded_torch.json"
    bps = flag("--blocks-per-shard")
    payload = run(out_path, shards=int(flag("--shards", 4)),
                  blocks_per_shard=None if bps is None else int(bps),
                  store_path=flag("--store"),
                  budgets=[int(x) for x in flag(
                      "--budgets", ",".join(map(str, BUDGETS))).split(",")],
                  merge_into=flag("--merge-into"),
                  log=lambda msg: print(msg, flush=True))
    print(json.dumps(payload, indent=2))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
