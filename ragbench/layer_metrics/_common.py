"""What the per-layer readers share: the least time of a scan call and of
a micro-batch, from ``ragbench/roofline.py``."""

from __future__ import annotations

from ragbench import roofline

TOPK_KERNELS = ("topk_partial_kernel", "topk_merge_kernel")


def scan_bound_s(d, batch: int, rows: int, bias: str) -> float:
    nbytes, ops = roofline.scan_work(batch, rows, d.dim, d.k,
                                     dtype=d.index_dtype, bias=bias)
    return roofline.bound(nbytes, ops, d.index_dtype)[0]


def encoder_bound_s(d, texts) -> float:
    e = d.encoder
    flops = roofline.encoder_flops(
        d.token_lengths(texts), hidden=e["hidden_size"],
        layers=e["num_hidden_layers"], intermediate=e["intermediate_size"])
    return flops / roofline.PEAK_OPS_PER_S["bfloat16"]


def idle_percent(d):
    dev = d.tracer.device
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
