#!/usr/bin/env python3
"""Co-located end-to-end HTTP serving benchmark on the PyTorch/CUDA port.

Counterpart of ``scripts/bench_serving_http.py``, with its flags and payload
keys.  The real data-manager HTTP service (``web/data_app.py``: the same
``create_data_app`` factory production uses, stdlib ``ThreadingHTTPServer``)
serves ``/api/query/hybrid`` from a ``TorchVectorStore(HashedNgramEmbedder())``
in the same process, over loopback sockets, to T client threads: request →
route → embed → fused scan → BM25 → fuse → JSON.  Three waves: a no-op POST
route on the same app (the HTTP stack's own ceiling: parse, dispatch, JSON),
the direct hybrid path, and the micro-batched one (``enable_micro_batching``,
``data_manager.serving.micro_batch``).

Departure from the JAX script: the JAX script forces its engine onto the CPU
backend (its engine sat behind a relay); the port's engine runs on the card
by default, and ``--device cpu`` reproduces the JAX measurement.  Its data
path and default output go under the temporary directory.  ``device`` is an
added key.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_bench_serving_http.py [--clients 256]
        [--per-client 20] [--chunks 10000] [--device cuda|cpu] [out.json]
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np


def _pctl(samples, p):
    return round(float(np.percentile(np.asarray(samples), p)) * 1e3, 2)


WORDS = ("quota scheduler dataset replica tensor queue lease shard batch "
         "token bucket cache index vector mesh kernel tile fuse probe "
         "segment postings ledger broker stream snapshot compaction "
         "grader rubric ticket triage oncall failover").split()


def synth_chunks(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = rng.choice(WORDS, size=60)
        out.append(f"chunk {i}: " + " ".join(w))
    return out


def query_texts(n: int) -> list[str]:
    """The JAX script's request texts."""
    return [f"problem with {WORDS[i % len(WORDS)]} and "
            f"{WORDS[(i * 7 + 3) % len(WORDS)]} setup" for i in range(n)]


def build_store(n_chunks: int, *, device, log=print):
    """A ``TorchVectorStore`` over the hashed featurizer holding
    ``synth_chunks(n_chunks)``, ingested 2048 at a time."""
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder

    store = TorchVectorStore(HashedNgramEmbedder(), device=device)
    texts = synth_chunks(n_chunks)
    t0 = time.time()
    bs = 2048
    for lo in range(0, n_chunks, bs):
        batch = texts[lo:lo + bs]
        store.add_texts(batch, [{"source": f"doc{lo + j}"}
                                for j in range(len(batch))],
                        ids=[f"c{lo + j}" for j in range(len(batch))])
    log(f"ingested {n_chunks} chunks in {time.time() - t0:.0f}s")
    return store


def measure(out_path=None, *, clients: int = 256, per_client: int = 20,
            n_chunks: int = 10_000, data_path=None, sample: int = 0,
            device=None, log=print):
    """The JAX script's three waves → ``(result, state)``: its payload
    (written to ``out_path`` when given) and ``state``: ``store`` and
    ``answers`` ({wave: {request index: JSON body}} for ``sample`` requests
    of each hybrid wave drawn with seed 5), ``queries``.  ``device``: the
    card unless ``"cpu"``."""
    import http.client

    import torch

    from archi_tpu_torch.data.catalog import CatalogService
    from archi_tpu_torch.data.data_manager import DataManager
    from archi_tpu_torch.utils.hardware import default_device
    from archi_tpu_torch.web.data_app import create_data_app

    dev = default_device(device)
    store = build_store(n_chunks, device=dev, log=log)
    own_data = data_path is None
    if own_data:
        data_path = tempfile.mkdtemp(prefix="bench_http_data_")
    dm = DataManager(data_path=data_path,
                     catalog=CatalogService(":memory:"), vectorstore=store)
    app = create_data_app(data_manager=dm)

    @app.post("/api/bench/noop")
    def noop(req):  # HTTP-stack-only ceiling: parse request, emit JSON
        return {"ok": True, "n": len(req.json().get("query", ""))}

    port = app.serve("127.0.0.1", 0, background=True)
    log(f"data app serving on :{port}")
    queries = query_texts(clients * per_client)
    keep = set(np.random.default_rng(5).choice(
        len(queries), min(sample, len(queries)), replace=False).tolist())
    answers: dict = {}

    def run_wave(path, body_of, name=None):
        lat = []
        lock = threading.Lock()
        got = answers.setdefault(name, {}) if name else None
        errors = []

        def worker(base):
            conn = http.client.HTTPConnection("127.0.0.1", port)
            mine, seen = [], {}
            try:
                for j in range(per_client):
                    qi = base * per_client + j
                    t0 = time.time()
                    conn.request("POST", path, json.dumps(body_of(
                        queries[qi])), {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    payload = r.read()
                    if r.status != 200:
                        raise RuntimeError(f"{path}: HTTP {r.status}: "
                                           f"{payload[:200]!r}")
                    mine.append(time.time() - t0)
                    if got is not None and qi in keep:
                        seen[qi] = json.loads(payload)
            except Exception as exc:  # reported by the wave, not the thread
                errors.append(exc)
            finally:
                conn.close()
            with lock:
                lat.extend(mine)
                if got is not None:
                    got.update(seen)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(clients)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        if errors:
            raise errors[0]
        n = clients * per_client
        return {"requests": n, "wall_s": round(wall, 2),
                "qps": round(n / wall, 1),
                "p50_ms": _pctl(lat, 50), "p99_ms": _pctl(lat, 99)}

    def hybrid(q):
        return {"query": q, "k": 5}

    try:
        # warmup (the scan's shapes, the caches)
        run_wave("/api/query/hybrid", hybrid)
        where = ("the card, " + torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "the CPU")
        result = {
            "setup": f"real data-manager HTTP app (create_data_app + "
                     f"ThreadingHTTPServer) co-located with the engine on "
                     f"{where}, ONE process, loopback sockets; {n_chunks} "
                     f"chunks, hash embedder, {clients} client threads x "
                     f"{per_client} requests; {os.cpu_count()} host cores "
                     f"(server + clients + host engine work share them)",
            "noop_http": run_wave("/api/bench/noop",
                                  lambda q: {"query": q}),
            "hybrid_end_to_end": run_wave("/api/query/hybrid", hybrid,
                                          "hybrid_end_to_end"),
        }
        # production co-located config: concurrent requests coalesce into
        # one fused engine pass through the MicroBatcher
        store.enable_micro_batching(max_batch=64, max_wait_ms=4.0,
                                    workers=2)
        result["hybrid_micro_batched"] = run_wave(
            "/api/query/hybrid", hybrid, "hybrid_micro_batched")
    finally:
        app.shutdown()
        if store._batcher is not None:
            store._batcher.close()
            store._batcher = None
        if own_data:
            shutil.rmtree(data_path, ignore_errors=True)
    result["device"] = str(dev)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result, {"store": store, "answers": answers, "queries": queries}


def run(out_path=None, **kw) -> dict:
    """``measure`` → its payload."""
    return measure(out_path, **kw)[0]


def main() -> None:
    args = sys.argv[1:]
    flags = ("--clients", "--per-client", "--chunks", "--device")
    values = {args[i + 1] for i, a in enumerate(args[:-1]) if a in flags}
    out_path = next((a for a in args if not a.startswith("-")
                     and a not in values),
                    os.path.join(tempfile.gettempdir(), "serving_http.json"))
    clients = int(args[args.index("--clients") + 1]) \
        if "--clients" in args else 256
    per_client = int(args[args.index("--per-client") + 1]) \
        if "--per-client" in args else 20
    n_chunks = int(args[args.index("--chunks") + 1]) \
        if "--chunks" in args else 10_000
    device = args[args.index("--device") + 1] if "--device" in args else None
    result = run(out_path, clients=clients, per_client=per_client,
                 n_chunks=n_chunks, device=device,
                 log=lambda m: print(m, flush=True))
    print(json.dumps(result, indent=2), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
