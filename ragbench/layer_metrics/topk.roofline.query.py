"""Flat index and its kernel (``engine/flat_index.py`` →
``csrc/fused_topk.cu``): the scan's least time (live rows, queries and
bias once, at 3.35 TB/s, or its products at the bf16 peak) over the
``fused_topk`` kernels' time in the traced slice."""

from ragbench.layer_metrics._common import TOPK_KERNELS, scan_bound_s


def read(d):
    dev = d.tracer.device
    if not dev:
        return None
    t0, t1 = d.tracer.slice
    calls = [s for s in d.tracer.of("scan") if t0 <= s[1] <= t1]
    kernel_s = sum(v for n, v in dev["kernel_s"].items()
                   if any(k in n for k in TOPK_KERNELS))
    launches = sum(v for n, v in dev["kernel_n"].items()
                   if "topk_partial_kernel" in n)
    if not calls or kernel_s <= 0 or launches <= 0:
        return None
    mean_bound = sum(scan_bound_s(d, b, rows, bias)
                     for _, _, _, (b, rows, bias) in calls) / len(calls)
    return 100.0 * mean_bound * launches / kernel_s
