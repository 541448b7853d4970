"""Flat index and its kernel (``engine/flat_index.py`` →
``csrc/fused_topk.cu``): the scan's least time (live rows, queries and
bias once, at 3.35 TB/s, or its products at the bf16 peak), with each
call's shape from the program's ``index.dispatch`` spans in the traced
slice, over the ``fused_topk`` kernels' time in the slice's device
trace."""

from ragbench.layer_metrics._common import TOPK_KERNELS
from ragbench.layer_metrics._spans import dispatch_bound_s, named, slice_spans


def read(d):
    dev = d.tracer.device
    spans = slice_spans(d)
    if not dev or not spans:
        return None
    calls = named(spans, "index.dispatch")
    kernel_s = sum(v for n, v in dev["kernel_s"].items()
                   if any(k in n for k in TOPK_KERNELS))
    launches = sum(v for n, v in dev["kernel_n"].items()
                   if "topk_partial_kernel" in n)
    if not calls or kernel_s <= 0 or launches <= 0:
        return None
    mean_bound = sum(dispatch_bound_s(d, s) for s in calls) / len(calls)
    return 100.0 * mean_bound * launches / kernel_s
