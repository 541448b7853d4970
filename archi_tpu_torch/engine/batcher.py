"""Micro-batching query scheduler: coalesce concurrent single-query
requests into fused device batches.

Counterpart of ``archi_tpu/engine/batcher.py`` (copied; the counters go to
``archi_tpu_torch.utils.metrics.METRICS``).  The device scan is
batch-shaped: one fused pass scores B queries for little more than the cost
of one, so a serving stack that forwards each HTTP request on its own
leaves that throughput unused under concurrency.  Inference servers call
this dynamic batching.

Design: callers block in ``submit``; worker threads drain the queue, group
requests by a compatibility signature (k, weights, filter — anything that
must be uniform within one fused call), execute whole groups through the
supplied batch function, and wake each caller with its slice.  The first
request in an empty queue waits at most ``max_wait_s`` for companions —
bounded added latency, multiplicative throughput.

Failure isolation: a batch-function exception fans out to exactly the
requests in that group (callers re-raise); the worker never dies.

Spans (``utils/tracing.py``): ``batcher.batch`` around each batch (its
id, size and kind), and for each of its requests ``batcher.queue``, from
the request's submit to the batch's start.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Sequence

from archi_tpu_torch.utils import tracing
from archi_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger(__name__)

_REQUEST_IDS = itertools.count(1)


@dataclass
class _Request:
    payload: Any
    signature: Hashable
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None
    # stamped at submit whether or not spans record, so that a request
    # queued before recording began still gets its whole queue span
    submitted_ns: int = field(default_factory=time.perf_counter_ns)
    id: int = field(default_factory=lambda: next(_REQUEST_IDS))


class MicroBatcher:
    """run_batch(signature, payloads) -> results, one per payload."""

    def __init__(self, run_batch: Callable[[Hashable, Sequence[Any]], list],
                 *, max_batch: int = 32, max_wait_s: float = 0.004,
                 workers: int = 2, name: str = "query",
                 submit_timeout_s: float | None = None):
        """workers: batches in flight concurrently.  One worker serializes
        every batch behind the host work of the one before; 2-4 workers let
        one batch's host work (BM25, tokenizing) overlap another's device
        pass.

        submit_timeout_s: upper bound on how long a caller blocks in
        ``submit`` (None = forever).  If ``run_batch`` wedges, serving
        threads would otherwise be stranded with no recourse (``close()``
        only joins workers for 5 s).
        """
        self._run_batch = run_batch
        self.name = name
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.submit_timeout_s = (
            None if submit_timeout_s is None else float(submit_timeout_s))
        self._queue: list[_Request] = []
        self._cv = threading.Condition()
        self._closed = False
        self._workers = [
            threading.Thread(target=self._loop,
                             name=f"micro-batcher-{name}-{i}", daemon=True)
            for i in range(max(1, int(workers)))
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------ API
    def submit(self, payload: Any, signature: Hashable = (),
               timeout: float | None = None) -> Any:
        """Block until the batched result for this payload is available.

        Raises TimeoutError after ``timeout`` (default: the batcher's
        ``submit_timeout_s``) if the batch never completes.  A timed-out
        request may still be executed by a worker later; its result is
        dropped.
        """
        req = _Request(payload, signature)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(req)
            self._cv.notify()
        if timeout is None:
            timeout = self.submit_timeout_s
        if not req.done.wait(timeout):
            # best-effort dequeue so an untaken request doesn't execute
            with self._cv:
                if req in self._queue:
                    self._queue.remove(req)
            raise TimeoutError(
                f"micro-batch result not ready within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=5)

    # --------------------------------------------------------------- worker
    def _take_group(self) -> tuple[list[_Request], int]:
        """Wait for work, linger briefly for companions, then take the
        largest same-signature group (FIFO head's signature).  Returns the
        group and the number of requests it left in the queue."""
        with self._cv:
            while True:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return [], 0
                # linger: let concurrent callers join this batch.  A single
                # wait() would wake on the FIRST notify and take a 2-request
                # group under bursts — re-wait until the window closes or
                # the batch fills.
                deadline = time.monotonic() + self.max_wait_s
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                if not self._queue:
                    continue   # a sibling worker drained it during linger
                sig = self._queue[0].signature
                group = [r for r in self._queue if r.signature == sig]
                group = group[: self.max_batch]
                taken = set(map(id, group))
                self._queue = [r for r in self._queue if id(r) not in taken]
                return group, len(self._queue)

    def _kind(self, signature: Hashable) -> str:
        """The search kind a signature starts with, else the batcher's
        name."""
        if isinstance(signature, tuple) and signature \
                and isinstance(signature[0], str):
            return signature[0]
        return self.name

    def _loop(self) -> None:
        while True:
            group, depth = self._take_group()
            if not group:
                return
            METRICS.inc("archi_micro_batches_total")
            METRICS.inc("archi_micro_batched_requests_total",
                        value=len(group))
            sig = group[0].signature
            with tracing.span("batcher.batch") as s:
                if s.recording:
                    for r in group:
                        tracing.record("batcher.queue", r.submitted_ns,
                                       s.start_ns, request=r.id, batch=s.id,
                                       depth=depth)
                    s.set(batch=s.id, size=len(group), kind=self._kind(sig))
                self._run_group(sig, group)

    def _run_group(self, sig: Hashable, group: list[_Request]) -> None:
        try:
            results = self._run_batch(sig, [r.payload for r in group])
            if len(results) != len(group):
                raise RuntimeError(
                    f"batch fn returned {len(results)} results for "
                    f"{len(group)} requests")
            for r, res in zip(group, results):
                r.result = res
        except BaseException as e:  # noqa: BLE001 — fan out to callers
            logger.exception("micro-batch failed (%d requests)", len(group))
            for r in group:
                r.error = e
        finally:
            for r in group:
                r.done.set()


def hybrid_batcher(store, *, max_batch: int = 32,
                   max_wait_s: float = 0.004,
                   workers: int = 2) -> MicroBatcher:
    """A MicroBatcher wired to the store's batched search paths.

    The signature's first element is the search kind ("hybrid" or
    "semantic"); the rest are the parameters that must be uniform within
    one fused call (k, weights, filter-items, enabled-ids).
    """
    def run(sig, payloads):
        if sig[0] == "semantic":
            _, k, filt, eids = sig
            return store.similarity_search_batch(
                list(payloads), k,
                filter=dict(filt) if filt else None,
                enabled_ids=set(eids) if eids is not None else None)
        _, k, sw, bw, filt, eids = sig
        return store.hybrid_search_batch(
            list(payloads), k,
            semantic_weight=sw, bm25_weight=bw,
            filter=dict(filt) if filt else None,
            enabled_ids=set(eids) if eids is not None else None)

    return MicroBatcher(run, max_batch=max_batch, max_wait_s=max_wait_s,
                        workers=workers, name="query")


def _filt_key(filter, enabled_ids):
    # enabled_ids may mix int chunk ids and str resource hashes — plain
    # sorted() raises on mixed types that the unbatched path accepts
    def _k(x):
        return (type(x).__name__, str(x))

    return (tuple(sorted(filter.items(), key=_k)) if filter else (),
            tuple(sorted(enabled_ids, key=_k))
            if enabled_ids is not None else None)


def hybrid_signature(k, semantic_weight, bm25_weight, filter, enabled_ids):
    return ("hybrid", int(k), float(semantic_weight), float(bm25_weight),
            *_filt_key(filter, enabled_ids))


def semantic_signature(k, filter, enabled_ids):
    return ("semantic", int(k), *_filt_key(filter, enabled_ids))
