#!/usr/bin/env python3
"""Concurrent-serving micro-batch benchmark (engine level) on the
PyTorch/CUDA port.

Counterpart of ``scripts/bench_serving.py``, with its flags and payload keys.
T client threads issue single queries against a 2^20 x 384 bf16 corpus on
the card through ``engine.batcher.MicroBatcher``; requests coalesce into
fused ``topk_scores`` batches (shared zero bias: the corpus scan is the cost
being amortised).  Batches pad to power-of-two buckets, each warmed before
the timed run.

Modes:
  (default)       dispatch-per-batch: every batch copies its queries to the
                  card and its results back, synchronously, as an HTTP
                  handler does; before it, the request-at-a-time baseline
                  (``unbatched_qps``: the same threads, four device calls at
                  a time, no coalescing).
  --in-process    the co-located ceiling: the queries are staged on the card
                  once; a batch sends its request indices (pinned, without
                  waiting), gathers the rows on the card and queues the scan
                  without a host sync (``host_syncs_per_batch``, counted
                  under ``torch.cuda.set_sync_debug_mode`` in steady
                  state, says so); one synchronise at the end.  The four worker threads share one
                  stream, so a batch's scan queues behind the one before.
                  Also a scheduler-only pass (a no-op batch function).  p50
                  / p99 client latency: every 32nd request of a client pulls
                  one scalar of its own result (a sync of the stream), minus
                  ``benchmarking.timing.measure_relay_rtt``, which on the
                  card is its sync-and-copy round trip (the JAX key
                  ``relay_rtt_ms_subtracted`` is kept).

Departures from the JAX script: the corpus comes from a ``torch.Generator``
seeded 0 on the card (``jax.random.normal(PRNGKey(0))`` cannot be drawn
without JAX; the queries are the JAX script's, from numpy seed 3); the
``impl=`` choice is gone (the port's ``topk_scores`` takes the kernel on the
card); ``device``, ``host_syncs_per_batch`` and ``host_syncs_first_call``
are added keys.  Times are
the card's: ``PERF.md`` gives them with the card's name and power limit.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_bench_serving.py [--clients 256]
        [--batches 32,128,256] [--per-client 40] [--in-process]
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import warnings

import numpy as np

N, D, K = 1 << 20, 384, 10


def _pctl(samples, p):
    return round(float(np.percentile(np.asarray(samples), p)) * 1e3, 2)


def make_corpus(rows: int = N, dim: int = D, *, device):
    """[rows, dim] bf16 rows drawn as f32 normals from a ``torch.Generator``
    seeded 0 on ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn((rows, dim), dtype=torch.float32, device=device,
                       generator=g).to(torch.bfloat16)


def _pad_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def make_run_batch(corpus, *, k: int = K, batch_sizes=None):
    """The dispatch-per-batch function: stack the requests' queries, pad to
    a power-of-two bucket with zero queries, one fused scan, the results
    copied back → one (vals [k], rows [k]) a request."""
    import torch

    from archi_tpu_torch.engine.topk import topk_scores

    dev = corpus.device
    n, d = corpus.shape
    bias = torch.zeros((n,), dtype=torch.float32, device=dev)

    def run_batch(_sig, reqs):
        q = np.stack(reqs).astype(np.float32)
        b = q.shape[0]
        bp = _pad_pow2(b)
        if bp > b:
            q = np.concatenate([q, np.zeros((bp - b, d), np.float32)])
        v, i = topk_scores(torch.as_tensor(q, device=dev), corpus, bias, n,
                           k=k)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        if batch_sizes is not None:
            batch_sizes.append(b)
        return [(v[j], i[j]) for j in range(b)]

    return run_batch


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_syncs(fn, dev) -> list[str]:
    """Where ``fn()`` made a synchronising CUDA call (``file:line`` of each
    warning of ``torch.cuda.set_sync_debug_mode``; none off the card)."""
    import torch

    if dev.type != "cuda":
        fn()
        return []
    _sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def measure(*, clients: int = 256, batches=(32, 128, 256),
            per_client: int = 40, in_process: bool = False, rows: int = N,
            sample: int = 0, device=None, log=print):
    """The JAX script's runs → ``(results, state)``: its payload and
    ``state["answers"]``: for ``sample`` requests drawn with seed 5, each
    run's answer by request index ({(mode, max_batch): {gi: (vals,
    rows)}}), with ``queries`` and ``corpus`` to check them against.
    ``device``: the card unless ``"cpu"``."""
    import torch

    from archi_tpu_torch.benchmarking.timing import measure_relay_rtt
    from archi_tpu_torch.engine.batcher import MicroBatcher
    from archi_tpu_torch.engine.topk import topk_scores
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    corpus = make_corpus(rows, D, device=dev)
    n, d = corpus.shape
    bias = torch.zeros((n,), dtype=torch.float32, device=dev)
    _sync(dev)

    results = {"clients": clients, "rows": n, "dim": d, "k": K,
               "per_client": per_client, "sweep": [],
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}

    rng = np.random.default_rng(3)
    queries = rng.standard_normal((clients * per_client, d)) \
        .astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    total = clients * per_client
    keep = set(np.random.default_rng(5).choice(
        total, min(sample, total), replace=False).tolist())
    answers: dict = {}

    def client_pump(submit_fn, lat_out=None, sample_every=0, rtt_sub=0.0):
        """Drive ``clients`` threads x ``per_client`` requests through
        submit_fn(global_request_index); → elapsed seconds.  Records a
        latency sample (minus rtt_sub) for every ``sample_every``-th request
        of a client through the callable submit_fn returns (it blocks until
        the result is real), or for every request without
        ``sample_every``."""
        done = threading.Barrier(clients + 1)

        def client(cid):
            done.wait()
            for j in range(per_client):
                t0 = time.time()
                blocker = submit_fn(cid * per_client + j)
                if sample_every and j % sample_every == 0:
                    if blocker is not None:
                        blocker()
                    if lat_out is not None:
                        lat_out.append(max(time.time() - t0 - rtt_sub, 0.0))
                elif lat_out is not None and not sample_every:
                    lat_out.append(time.time() - t0)
            done.wait()

        ts = [threading.Thread(target=client, args=(c,))
              for c in range(clients)]
        for t in ts:
            t.start()
        done.wait()
        t0 = time.time()
        done.wait()
        dt = time.time() - t0
        for t in ts:
            t.join()
        return dt

    def run_once(max_batch: int):
        batch_sizes: list[int] = []
        run_batch = make_run_batch(corpus, batch_sizes=batch_sizes)
        mb = MicroBatcher(run_batch, max_batch=max_batch, max_wait_s=0.004,
                          workers=4)
        bsz = 1                       # warm every pow2 bucket <= max_batch
        while bsz <= max_batch:
            run_batch(None, list(queries[:bsz]))
            bsz *= 2
        del batch_sizes[:]
        got = answers.setdefault(("dispatch", max_batch), {})

        def submit(gi):
            out = mb.submit(queries[gi])
            if gi in keep:
                got[gi] = out

        dt = client_pump(submit)
        mb.close()
        entry = {
            "max_batch": max_batch,
            "qps": round(total / dt, 1),
            "mean_batch": round(float(np.mean(batch_sizes)), 1)
            if batch_sizes else 0.0,
            "n_batches": len(batch_sizes),
        }
        results["sweep"].append(entry)
        log(json.dumps(entry))

    def run_scheduler_only():
        """The MicroBatcher machinery alone: a host no-op batch function."""
        def run_batch(_sig, reqs):
            return [None] * len(reqs)

        mb = MicroBatcher(run_batch, max_batch=256, max_wait_s=0.004,
                          workers=4)
        lats: list[float] = []
        dt = client_pump(lambda gi: mb.submit(gi) or (lambda: None),
                         lat_out=lats)
        mb.close()
        entry = {"mode": "scheduler_only_noop",
                 "qps": round(total / dt, 1),
                 "lat_p50_ms": _pctl(lats, 50),
                 "lat_p99_ms": _pctl(lats, 99)}
        results["sweep"].append(entry)
        log(json.dumps(entry))

    def run_in_process(max_batch: int, rtt: float):
        """Co-located ceiling: queries staged on the card; a batch gathers
        its rows there and queues the scan without a host sync; one
        synchronise at the end."""
        dev_q = torch.as_tensor(queries, device=dev)
        _sync(dev)
        batch_sizes: list[int] = []

        def run_batch(_sig, reqs):
            idx = np.asarray(reqs, np.int64)
            b = len(idx)
            bp = _pad_pow2(b)
            if bp > b:
                idx = np.pad(idx, (0, bp - b))
            ii = torch.from_numpy(idx)
            if dev.type == "cuda":
                ii = ii.pin_memory().to(dev, non_blocking=True)
            q = torch.index_select(dev_q, 0, ii)
            v, i = topk_scores(q, corpus, bias, n, k=K)
            batch_sizes.append(b)
            return [(v, i, j) for j in range(b)]

        mb = MicroBatcher(run_batch, max_batch=max_batch, max_wait_s=0.004,
                          workers=4)
        bsz = 1                       # warm every pow2 bucket
        while bsz <= max_batch:
            run_batch(None, list(range(bsz)))
            bsz *= 2
        # the batch function's host syncs in steady state: its third call
        # at the largest bucket (the first calls may still allocate the
        # pinned staging buffers); where the first call synchronised, too
        first = host_syncs(lambda: run_batch(None, list(range(max_batch))),
                           dev)
        run_batch(None, list(range(max_batch)))
        syncs = host_syncs(lambda: run_batch(None, list(range(max_batch))),
                           dev)
        _sync(dev)
        del batch_sizes[:]
        got = answers.setdefault(("in_process", max_batch), {})
        lats: list[float] = []

        def submit(gi):
            v, i, j = mb.submit(gi)
            if gi in keep:
                got[gi] = (v, i, j)
            return lambda: float(v[j, 0])    # one scalar pull

        dt = client_pump(submit, lat_out=lats, sample_every=32, rtt_sub=rtt)
        _sync(dev)
        mb.close()
        for gi, (v, i, j) in got.items():
            got[gi] = (v[j].cpu().numpy(), i[j].cpu().numpy())
        entry = {"mode": "in_process_async", "max_batch": max_batch,
                 "qps": round(total / dt, 1),
                 "mean_batch": round(float(np.mean(batch_sizes)), 1)
                 if batch_sizes else 0.0,
                 "n_batches": len(batch_sizes),
                 "lat_p50_ms": _pctl(lats, 50),
                 "lat_p99_ms": _pctl(lats, 99),
                 "lat_samples": len(lats),
                 "relay_rtt_ms_subtracted": round(rtt * 1e3, 1),
                 "host_syncs_per_batch": len(syncs),
                 "host_syncs_first_call": first}
        results["sweep"].append(entry)
        log(json.dumps(entry))

    def run_unbatched():
        """Request-at-a-time baseline: the same threads, no coalescing,
        four device calls at a time."""
        sem = threading.Semaphore(4)

        def one(q):
            with sem:
                v, i = topk_scores(torch.as_tensor(q[None], device=dev),
                                   corpus, bias, n, k=K)
                return v.cpu().numpy()

        def submit(gi):
            one(queries[gi])

        one(queries[0])
        dt = client_pump(submit)
        results["unbatched_qps"] = round(total / dt, 1)
        log(json.dumps({"unbatched_qps": results["unbatched_qps"]}))

    if in_process:
        rtt = measure_relay_rtt(device=dev)
        results["relay_rtt_ms"] = round(rtt * 1e3, 1)
        run_scheduler_only()
        for mbs in batches:
            run_in_process(mbs, rtt)
    else:
        run_unbatched()
        for mbs in batches:
            run_once(mbs)
    return results, {"answers": answers, "queries": queries,
                     "corpus": corpus}


def run(**kw) -> dict:
    """``measure`` → its payload."""
    return measure(**kw)[0]


def main() -> None:
    args = sys.argv[1:]
    clients = (int(args[args.index("--clients") + 1])
               if "--clients" in args else 256)
    batches = [int(x) for x in (
        args[args.index("--batches") + 1] if "--batches" in args
        else "32,128,256").split(",")]
    per_client = (int(args[args.index("--per-client") + 1])
                  if "--per-client" in args else 40)
    results = run(clients=clients, batches=batches, per_client=per_client,
                  in_process="--in-process" in args,
                  log=lambda m: print(m, flush=True))
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
