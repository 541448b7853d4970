"""The whole micro-batch, store to device (``engine/vectorstore.py``), from
the program's spans: the least time of the batches' work (the scans'
bytes, from the ``index.dispatch`` attributes, at 3.35 TB/s plus the
encoder FLOPs of the ``embed.encode`` token lengths at 989 TFLOP/s) over
the summed wall time of the ``batcher.batch`` spans in the traced
slice."""

from ragbench import roofline
from ragbench.layer_metrics._spans import (batches, dispatch_bound_s,
                                           slice_spans, under_batches)


def read(d):
    spans = slice_spans(d)
    if not spans:
        return None
    wall = sum(s.wall_ns for s in batches(spans, d.kind)) / 1e9
    scans = under_batches(spans, "index.dispatch", d.kind)
    encodes = under_batches(spans, "embed.encode", d.kind)
    if wall <= 0 or not scans or not encodes:
        return None
    least = sum(dispatch_bound_s(d, s) for s in scans)
    e = d.encoder
    least += roofline.encoder_flops(
        [n for s in encodes for n in s.attrs["lengths"]],
        hidden=e["hidden_size"], layers=e["num_hidden_layers"],
        intermediate=e["intermediate_size"]) / roofline.PEAK_OPS_PER_S["bfloat16"]
    return 100.0 * least / wall
