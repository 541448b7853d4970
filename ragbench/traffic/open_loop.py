"""Retrieval requests from independent users: an open loop at a fixed rate.

The mix file gives the retriever (``hybrid`` or ``semantic``), the offered
rate, the share of queries whose words no document holds, the request
threads, how many answers the check compares, and where in the window the
traced slice starts (it runs to the window's close).  Arrivals are
Poisson: the window's gaps are a fixed set of exponential quantiles (so
every seed offers the same load) in an order drawn from the seed.  Each
request is timed from the moment the schedule made it due, so a stall
delays the requests behind it; the generator dispatches from a thread pool
that never waits on the system, and logs how late it ran.
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import threading
import time
import types

import numpy as np

from ragbench import deploy, stats, textgen
from ragbench.check import judge_queries, token_lengths
from ragbench.runctx import Outcome, Run
from ragbench.trace import counters
from ragbench.weights import encoder_weights

COUNTERS = ["archi_micro_batches_total", "archi_micro_batched_requests_total"]
#: seconds a request may finish after the window closes before it counts
#: as never answered: above capacity the backlog drains after the close,
#: and in a traced run while the profiler stops
GRACE_S = 90.0


def arrival_offsets(n: int, seconds: float, rng) -> np.ndarray:
    """n arrival times in [0, seconds): exponential gaps at fixed quantiles,
    shuffled, scaled to fill the window."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)[rng.permutation(n)]
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def batch_fn(st, kind: str):
    return st.hybrid_search_batch if kind == "hybrid" else \
        st.similarity_search_batch


def warm(r: Run, st, ret, kind: str, k: int, probes: list[str]) -> None:
    """Every batch bucket the scheduler forms, through the batched call its
    workers make, then bursts through the retriever and the scheduler."""
    mb = r.config["archi"]["micro_batch"]["max_batch"]
    fn = batch_fn(st, kind)
    b = 1
    while True:
        fn(probes[:b], k)
        if b >= mb:
            break
        b = min(2 * b, mb)
    with concurrent.futures.ThreadPoolExecutor(2 * mb) as pool:
        for _ in range(3):
            list(pool.map(ret.invoke, probes[:2 * mb]))
    r.free()


def install_spans(r: Run, st, kind: str) -> None:
    tr = r.tracer

    def set_batch(a, kw):
        tr.local.batch = len(a[0])

    tr.wrap(st, "hybrid_search_batch" if kind == "hybrid"
            else "similarity_search_batch", "batch",
            info=lambda a, kw, res: list(a[0]), before=set_batch)
    tr.wrap(st, "_embed_queries", "embed")
    tr.wrap(st.bm25, "scores", "bm25")
    tr.wrap(st.index, "search_dispatch", "scan",
            info=lambda a, kw, res: (
                getattr(tr.local, "batch", 1), len(st.index),
                "per_query" if getattr(kw.get("bias"), "dim", lambda: 1)() == 2
                else "shared"))


class Deployment:
    """The cell's store, retriever and request pool, built once; a sweep
    runs several windows over one."""

    def __init__(self, r: Run):
        cfg, tr = r.config, r.traffic
        self.r = r
        self.kind = tr["retriever"]
        self.k = cfg["archi"]["retrievers"][self.kind]["k"]
        self.corpus = deploy.corpus_module(cfg).Corpus(cfg, r.seed, r.device)
        self.weights = encoder_weights(cfg["encoder"], r.seed, r.device)
        self.emb = deploy.embedder(cfg, self.weights, self.corpus.wp_vocab,
                                   r.device)
        r.log("corpus, weights and embedder made")
        self.st = deploy.store(cfg, self.emb, r.device)
        self.corpus.fill(self.st)
        r.log(f"store: {self.st.count()} rows of {cfg['encoder']['hidden_size']}")
        deploy.serve(cfg, self.st)
        self.ret = deploy.retriever(cfg, self.kind, self.st)
        self.pool = concurrent.futures.ThreadPoolExecutor(tr["max_in_flight"])
        gate = threading.Barrier(tr["max_in_flight"] + 1)
        for _ in range(tr["max_in_flight"]):
            self.pool.submit(gate.wait)
        gate.wait()

    def queries(self, n: int) -> tuple[list[str], list[str]]:
        """(warm-up probes, n window queries)."""
        mb = self.r.config["archi"]["micro_batch"]["max_batch"]
        q = self.corpus.queries(n + 2 * mb, self.r.traffic["unmatched_share"])
        return q[:2 * mb], q[2 * mb:]

    def window(self, queries: list[str], seconds: float, stream: str,
               keep=(), on_start=None, on_close=None):
        """Send the queries at Poisson arrivals over ``seconds``; wait for
        each until GRACE_S past the close.  Only the answers of the
        requests in ``keep`` are held (the sample the check compares).
        ``on_start`` runs at the first arrival of the traced slice,
        ``on_close`` when the window closes, before the backlog drains."""
        r, n = self.r, len(queries)
        offsets = arrival_offsets(n, seconds, textgen.rng_for(r.seed, stream))
        done, errors = [None] * n, [None] * n
        keep = set(keep)
        answers = {}

        def request(i: int) -> None:
            try:
                res = self.ret.invoke(queries[i])
                done[i] = time.perf_counter()
                if i in keep:
                    answers[i] = res
            except Exception as e:  # a failed request: it never answers
                errors[i] = repr(e)

        sl0 = r.traffic["trace_start"] * seconds
        late = np.zeros(n)
        futures = []
        pauses = gc_pauses()
        t0 = time.perf_counter() + 0.01
        due = t0 + offsets
        for i in range(n):
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if on_start is not None and offsets[i] >= sl0:
                on_start()
                on_start = None
            late[i] = time.perf_counter() - due[i]
            futures.append(self.pool.submit(request, i))
        t1 = t0 + seconds
        if on_close is not None:
            time.sleep(max(0.0, t1 - time.perf_counter()))
            on_close()
        concurrent.futures.wait(futures, timeout=max(
            0.0, t1 + GRACE_S - time.perf_counter()))
        unanswered = sum(d is None for d in done)
        r.log(f"generator late: median {np.median(late) * 1e3:.3f} ms, p99 "
              f"{np.percentile(late, 99) * 1e3:.3f} ms, max "
              f"{late.max() * 1e3:.3f} ms; {unanswered} unanswered; "
              f"{pauses()}"
              + (f" (first error: {next(e for e in errors if e)})"
                 if any(errors) else ""))
        return types.SimpleNamespace(due=due, done=done, answers=answers,
                                     t0=t0, t1=t1, unanswered=unanswered)

    def sample(self, queries: list[str], size: int) -> list[int]:
        """The requests whose answers the check compares, drawn from the
        seed before the window, the longest queries in it."""
        rng = textgen.rng_for(self.r.seed, "sample")
        longest = sorted(range(len(queries)),
                         key=lambda i: -len(queries[i]))[:8]
        rest = sorted(set(range(len(queries))) - set(longest))
        m = max(0, min(size, len(queries)) - len(longest))
        return longest + ([rest[j] for j in sorted(rng.choice(
            len(rest), m, replace=False).tolist())] if rest else [])

    def rows_of(self, ans) -> list[tuple[int, float]]:
        out = []
        for doc, score in ans:
            try:
                out.append((self.corpus.row_of(doc.metadata["chunk_id"]),
                            score))
            except (KeyError, ValueError):
                out.append((-1, score))
        return out

    def close(self) -> None:
        self.st._batcher.close()
        self.pool.shutdown(wait=True)
        del self.ret, self.st, self.emb
        self.r.free()

    def judge(self, queries: list[str], rows, control: bool) -> dict:
        return judge_queries(self.corpus, self.r.config, self.kind,
                             self.weights, queries, rows, self.r.device,
                             control=control)


def gc_pauses():
    """Count the interpreter's garbage collections from now on; the
    returned function reports them (how often the window stopped for
    them, and for how long)."""
    starts, spent = {}, collections.Counter()

    def cb(phase, info):
        if phase == "start":
            starts[info["generation"]] = time.perf_counter()
        else:
            g = info["generation"]
            spent[g] += time.perf_counter() - starts.pop(g, time.perf_counter())
            spent[f"n{g}"] += 1

    gc.callbacks.append(cb)

    def report() -> str:
        gc.callbacks.remove(cb)
        return "gc " + ", ".join(
            f"gen{g} {spent[f'n{g}']}x {spent[g] * 1e3:.1f} ms"
            for g in (0, 1, 2))

    return report


def end_to_end(w) -> dict:
    lat = stats.latencies_ms(w.due, w.done)
    return {"query_p95_ms": stats.percentile(lat, 95),
            "query_p50_ms": stats.percentile(lat, 50),
            "queries_per_s": stats.completed_rate(w.done, w.t0, w.t1)}


def run(r: Run) -> Outcome:
    cfg, tr = r.config, r.traffic
    dep = Deployment(r)
    n = int(round(tr["rate_per_s"] * r.seconds))
    probes, queries = dep.queries(n)
    warm(r, dep.st, dep.ret, dep.kind, dep.k, probes)
    r.log("warm")
    if r.tracer.enabled:
        install_spans(r, dep.st, dep.kind)
    r.tracer.arm()
    setup_s = r.setup_s()
    r.log(f"set-up {setup_s:.1f} s; window {r.seconds} s, {n} requests at "
          f"{tr['rate_per_s']}/s")
    sample = dep.sample(queries, tr["check_sample"])
    with counters(r.tracer, COUNTERS):
        w = dep.window(queries, r.seconds, "arrivals", keep=sample,
                       on_start=r.tracer.start_profile,
                       on_close=r.tracer.stop_profile)
    peak = r.memory_peak()
    e2e = end_to_end(w)
    r.log(f"latency p50 {e2e['query_p50_ms']:.3f} ms, p95 "
          f"{e2e['query_p95_ms']:.3f} ms; {e2e['queries_per_s']:.2f} "
          f"completed/s")
    # the sample's answers (an unanswered one is counted as such); then the
    # program is freed before the reference runs
    sample = [i for i in sample if i in w.answers]
    rows = [dep.rows_of(w.answers[i]) for i in sample]
    layer = types.SimpleNamespace(
        tracer=r.tracer, window_s=r.seconds, kind=dep.kind, k=dep.k,
        n_rows=dep.st.count(), dim=cfg["encoder"]["hidden_size"],
        index_dtype=cfg["index"]["dtype"], encoder=cfg["encoder"],
        token_lengths=token_lengths(dep.corpus.wp_vocab, cfg))
    dep.close()
    r.tracer.reduce()
    r.log(f"checking {len(sample)} answers against the reference")
    readings = dep.judge([queries[i] for i in sample], rows, r.control)
    for side in readings.values():
        side["unanswered"] = w.unanswered
    return Outcome(attempted=n, failed=w.unanswered, setup_s=setup_s,
                   end_to_end=e2e, memory_peak_bytes=peak,
                   readings=readings, layer_data=layer)
