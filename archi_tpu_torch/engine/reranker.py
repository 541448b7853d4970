"""Late-interaction (MaxSim) reranker.

Counterpart of ``archi_tpu/engine/reranker.py``: rerank the retriever's top
candidates with ColBERT-style token-level MaxSim —
``score(q, d) = Σ_i max_j  q_i · d_j`` over normalized token embeddings,
averaged over the query's tokens — using the same encoder's per-token
output (``models/bert.encode_tokens``, whose attention is the
``encoder_attention`` kernel on the card).  The MaxSim product itself is
one batched einsum over [C, Sd, H] candidates.

Usage: wrap any retriever with ``RerankingRetriever`` (over-fetches, then
reorders).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.models.bert import encode_tokens
from archi_tpu_torch.utils.documents import Document


def maxsim_scores(q_tok, q_mask, d_tok, d_mask) -> torch.Tensor:
    """q_tok [Sq, H], q_mask [Sq]; d_tok [C, Sd, H], d_mask [C, Sd]
    → [C] MaxSim scores (normalized tokens)."""
    def norm(x):
        return x / torch.clamp(
            torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)

    q = norm(q_tok.float())
    d = norm(d_tok.float())
    sim = torch.einsum("qh,csh->cqs", q, d)
    sim = torch.where(d_mask[:, None, :] > 0.5, sim,
                      torch.full_like(sim, -1e9))
    best = sim.amax(dim=-1)                           # [C, Sq]
    best = torch.where(q_mask[None, :] > 0.5, best, torch.zeros_like(best))
    return best.sum(dim=-1) / torch.clamp(q_mask.float().sum(), min=1.0)


class MaxSimReranker:
    def __init__(self, embedder, *, max_query_tokens: int = 32,
                 max_doc_tokens: int = 128):
        """embedder: a TorchEmbedder (provides tokenizer, model, config and
        device)."""
        self.embedder = embedder
        max_pos = embedder.config.max_position_embeddings
        self.max_q = min(max_query_tokens, max_pos)
        self.max_d = min(max_doc_tokens, max_pos)

    def _token_embed(self, texts: Sequence[str], max_len: int):
        """→ (per-token hidden states [n, max_len, H] f32, mask [n, max_len]
        f32), on the embedder's device."""
        tok = self.embedder.tokenizer
        ids = np.zeros((len(texts), max_len), np.int64)
        mask = np.zeros((len(texts), max_len), np.int64)
        for r, t in enumerate(texts):
            enc = tok.encode(t, max_len)
            ids[r, : len(enc)] = enc
            mask[r, : len(enc)] = 1
        dev = self.embedder.device
        ids_t = torch.from_numpy(ids).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        out = encode_tokens(self.embedder.model, ids_t, mask_t)
        return out, mask_t.float()

    def rerank(self, query: str,
               results: Sequence[tuple[Document, float]],
               *, top_k: Optional[int] = None):
        """(Document, score) list → re-ordered by MaxSim (new scores)."""
        if not results:
            return []
        docs = [d for d, _s in results]
        q_tok, q_mask = self._token_embed([query], self.max_q)
        d_tok, d_mask = self._token_embed(
            [d.page_content[: self.max_d * 8] for d in docs], self.max_d)
        scores = maxsim_scores(q_tok[0], q_mask[0], d_tok,
                               d_mask).cpu().numpy()
        order = np.argsort(-scores)
        out = [(docs[i], float(scores[i])) for i in order]
        return out[: top_k or len(out)]


class RerankingRetriever:
    """Wrap a retriever: over-fetch then MaxSim-reorder.

    ``RerankingRetriever(HybridRetriever(store, k=50), reranker, k=5)``
    """

    def __init__(self, base, reranker: MaxSimReranker, *, k: int = 5):
        self.base = base
        self.reranker = reranker
        self.k = k

    def invoke(self, query: str):
        candidates = self.base.invoke(query)
        return self.reranker.rerank(query, candidates, top_k=self.k)

    def __call__(self, query: str):
        return self.invoke(query)
