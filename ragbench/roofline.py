"""The chip's published peaks and the least time each piece of work needs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit (a card set
below it runs slower; every result line carries the card's power limit).
A share of a roofline is the least time over the measured time, where the
least time is the longer of bytes over HBM bandwidth and operations over
peak rate.  Bytes count each input once and each output once, whatever a
kernel reads again; the scan counts the live rows only, not the padded
capacity.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "fp8": 1979e12,
                  "int8": 1979e12, "tf32": 495e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least seconds for the work, and which limit sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_work(batch: int, rows: int, dim: int, k: int, *, dtype: str,
              bias: str) -> tuple[float, float]:
    """(bytes, operations) of one fused score-and-top-k scan: ``batch``
    queries against ``rows`` live rows of ``dim`` in ``dtype``, with an f32
    bias per row that is ``shared`` by the batch or ``per_query``; out come
    k f32 scores and k int32 rows a query."""
    nbytes = (rows * dim * DTYPE_BYTES[dtype]            # the rows
              + batch * dim * DTYPE_BYTES[dtype]         # the queries
              + rows * 4 * (batch if bias == "per_query" else 1)
              + batch * k * 8)                           # scores and rows
    return float(nbytes), 2.0 * batch * rows * dim


def encoder_flops(lengths, *, hidden: int, layers: int,
                  intermediate: int) -> float:
    """Multiply-adds × 2 of a BERT encoder over sequences of the given
    token counts (no padding): per token and layer the q, k, v and output
    projections and the two feed-forward products, per sequence and layer
    QK^T and PV over its own length."""
    h, f = hidden, intermediate
    per_token = 2 * (4 * h * h + 2 * h * f)
    total = 0.0
    for s in lengths:
        total += s * per_token + 2 * 2 * s * s * h
    return float(total * layers)
