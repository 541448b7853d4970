"""Batched Lloyd's k-means — the IVF centroid trainer.

Counterpart of ``archi_tpu/engine/kmeans.py``.  Assignment is one matmul
(``x @ centroids.T`` + argmax, first index on ties) and the update a
segment sum (``index_add_``).  The initial centroids are the rows that
``np.random.default_rng(seed).choice`` picks, so both packages start from
the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from archi_tpu_torch.utils.hardware import default_device


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Cosine/IP assignment (inputs normalized by the caller) → [n] int64."""
    return torch.argmax(x.float() @ centroids.T, dim=1)


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """→ (sums [k, D] f32, counts [k] f32) of the rows of each cluster."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, assign, x.float())
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, assign, torch.ones_like(assign, dtype=torch.float32))
    return sums, counts


def kmeans(x, k: int, *, iters: int = 15, seed: int = 0,
           batch: int = 1 << 18, device=None):
    """→ (centroids [k, D] f32, assignments [N] int32), on x's device.

    x must be L2-normalized (cosine k-means); a numpy array goes to
    ``device`` (default cuda).  Large N is processed in batches so memory
    holds one [batch, k] score block at a time; x keeps its stored dtype
    (bf16 corpora stay 2 bytes a value)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=default_device(device))
    n, d = x.shape
    k = min(k, n)
    # bound the [batch, k] f32 assignment-score block to ~1 GB
    batch = min(batch, max(8192, (1 << 28) // max(k, 1)))
    rng = np.random.default_rng(seed)
    init_idx = np.sort(rng.choice(n, size=k, replace=False))
    centroids = x[torch.as_tensor(init_idx, device=x.device)].float()

    starts = range(0, n, batch)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        for s in starts:
            xb = x[s:s + batch]
            sb, cb = _segment_sums(xb, _assign(xb, centroids), k)
            sums += sb
            counts += cb
        means = sums / torch.clamp(counts[:, None], min=1.0)
        # re-normalize for cosine; empty clusters keep their old centroid
        new_c = means / torch.clamp(
            torch.linalg.vector_norm(means, dim=1, keepdim=True), min=1e-12)
        centroids = torch.where(counts[:, None] > 0, new_c, centroids)

    assign = torch.cat([_assign(x[s:s + batch], centroids) for s in starts])
    return centroids, assign.to(torch.int32)
