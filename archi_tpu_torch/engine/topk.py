"""Top-k scoring dispatch: the fused CUDA kernel on the card, the plain
PyTorch version on the CPU.

Counterpart of ``archi_tpu/engine/topk.py``.  The score of row i is
``q · E[i] + bias[i]``:

- pure semantic: bias = 0 (alive) / NEG_INF (tombstoned / filtered out),
- hybrid: bias additionally carries ``bm25_weight * bm25_score[i]`` while
  the query is pre-scaled by ``semantic_weight``.
"""

from __future__ import annotations

import logging

import torch

from archi_tpu_torch.ops.topk import MAX_K, NEG_INF, fused_topk, plain_topk

__all__ = ["NEG_INF", "alive_to_bias", "pad_bias_rows", "next_pow2",
           "plain_topk", "topk_scores", "topk_lower_first", "FUSED_FALLBACKS"]

#: count of k > MAX_K calls served by the plain version (exported to
#: /metrics as ``archi_fused_topk_fallbacks_total``)
FUSED_FALLBACKS = {"count": 0}
_logger = logging.getLogger(__name__)


def alive_to_bias(alive: torch.Tensor) -> torch.Tensor:
    """0/1 liveness mask → additive bias (0 alive, NEG_INF dead)."""
    return torch.where(alive > 0.5, 0.0, NEG_INF).to(torch.float32)


def pad_bias_rows(bias: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-pad (or cut) the ROW axis of a [N] or per-query [B, N] bias to
    ``capacity``."""
    bb = bias.to(torch.float32)
    if bb.shape[-1] < capacity:
        bb = torch.nn.functional.pad(bb, (0, capacity - bb.shape[-1]))
    return bb[..., :capacity]


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def topk_lower_first(x: torch.Tensor, k: int):
    """Top-k along the last axis in ``lax.top_k``'s order: descending, equal
    values ranked by the lower position (``torch.topk`` does not promise
    that).  → (vals, positions int64), each [..., min(k, width)].

    ``torch.topk`` finds the k-th value; every entry above it is kept and
    the entries equal to it are kept lowest position first."""
    lead, w = x.shape[:-1], x.shape[-1]
    k = min(int(k), w)
    x2 = x.reshape(-1, w)
    if k == w or w <= 2048:
        vals, pos = torch.sort(x2, dim=1, descending=True, stable=True)
        vals, pos = vals[:, :k], pos[:, :k]
    else:
        kth = torch.topk(x2, k, dim=1).values[:, -1:]
        above = x2 > kth
        tied = x2 == kth
        room = k - above.sum(dim=1, keepdim=True)
        keep = above | (tied & (torch.cumsum(tied, dim=1) <= room))
        pos = keep.nonzero()[:, 1].reshape(-1, k)     # ascending per row
        vals = torch.gather(x2, 1, pos)
        order = torch.sort(vals, dim=1, descending=True, stable=True).indices
        vals, pos = vals.gather(1, order), pos.gather(1, order)
    return vals.reshape(*lead, k), pos.reshape(*lead, k)


def _count_fused_fallback(reason: str) -> None:
    FUSED_FALLBACKS["count"] += 1
    from archi_tpu_torch.utils.metrics import METRICS

    METRICS.inc("archi_fused_topk_fallbacks_total")
    _logger.warning("fused top-k fell back to the plain version (%s) — "
                    "fallback #%d", reason, FUSED_FALLBACKS["count"])


def topk_scores(queries, corpus, bias, n_active, *, k: int = 10):
    """Top-k of ``q · E[i] + bias[i]`` against the padded corpus.

    Args:
      queries: [B, D] float (pre-scaled by semantic_weight for hybrid).
      corpus: [N_pad, D] padded corpus (bf16, f32 or int8).
      bias: [N_pad] (shared) or [B, N_pad] (per-query) f32 additive bias.
      n_active: rows >= n_active are padding.
      k: number of neighbours.
    Returns:
      (vals [B, k] f32, idx [B, k] int32) — idx are physical row positions.

    CUDA tensors take the fused kernel at any corpus size; CPU tensors its
    plain version.  k > 128 (past the kernel's list) takes the plain
    version on either device, counted in
    ``archi_fused_topk_fallbacks_total`` and logged.
    """
    k = min(int(k), int(corpus.shape[0]))
    if k <= 0:
        b = queries.shape[0]
        dev = corpus.device
        return (torch.zeros((b, 0), dtype=torch.float32, device=dev),
                torch.zeros((b, 0), dtype=torch.int32, device=dev))
    if k > MAX_K:
        _count_fused_fallback(f"k={k}")
        return plain_topk(queries, corpus, bias, n_active, k=k)
    return fused_topk(queries, corpus, bias, n_active, k=k)
