"""The whole micro-batch, store to device (``engine/vectorstore.py``): the
least time of each batch's work (its scan's bytes at 3.35 TB/s plus its
queries' encoder FLOPs at 989 TFLOP/s), summed over the window's batches,
over the batches' summed wall time in the scheduler's workers."""

from ragbench.layer_metrics._common import encoder_bound_s, scan_bound_s


def read(d):
    batches = d.tracer.of("batch")
    if not batches:
        return None
    bias = "per_query" if d.kind == "hybrid" else "shared"
    least = sum(scan_bound_s(d, len(q), d.n_rows, bias) + encoder_bound_s(d, q)
                for _, _, _, q in batches)
    wall = sum(t1 - t0 for _, t0, t1, _ in batches)
    return 100.0 * least / wall
