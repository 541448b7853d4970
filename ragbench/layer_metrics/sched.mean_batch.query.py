"""Scheduler (``engine/batcher.py``): requests a micro-batch over the
window, from the counters ``archi_micro_batched_requests_total`` and
``archi_micro_batches_total``."""

from ragbench.trace import counter_delta


def read(d):
    batches = counter_delta(d.tracer, "archi_micro_batches_total")
    if batches <= 0:
        return None
    return counter_delta(d.tracer, "archi_micro_batched_requests_total") / batches
