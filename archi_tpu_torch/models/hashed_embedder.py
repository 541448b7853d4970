"""Deterministic training-free text featurizer ("hashed n-gram" embedder).

Counterpart of ``archi_tpu/models/hashed_embedder.py`` (numpy, copied; the
outputs are bit-identical).  A fully deterministic semantic space — signed
hashed bag of word-unigrams + char-3-grams with a stable md5-based
projection, L2 normalized — in which lexical/sub-lexical similarity IS the
ground truth, so retrieval quality can be measured without a pretrained
checkpoint.  Implements the ``Embeddings`` contract
(``embed_documents`` / ``embed_query``).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from archi_tpu_torch.models.tokenizer import basic_tokenize


def _stable_hash(token: str) -> int:
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "little")


class HashedNgramEmbedder:
    """Text → deterministic normalized feature vector.

    Features: word unigrams (weight 1.0) + char trigrams of each word
    (weight 0.4, so morphological variants like "scheduler"/"scheduling"
    land near each other).  Each feature hashes to a (dim-index, sign)
    pair — the classic hashing trick; cosine similarity then approximates
    weighted feature overlap.
    """

    #: embed_query(q) == embed_documents([q])[0] — declaring the (empty)
    #: prefix opts this embedder into the store's batched-embed contract
    #: (TorchVectorStore._embed_queries).
    instruction_prefix = ""

    def __init__(self, dim: int = 384, *, char_weight: float = 0.4):
        self.dim = dim
        self.char_weight = char_weight

    def _features(self, text: str):
        for tok in basic_tokenize(text):
            if not tok.isalnum():
                continue
            yield "w:" + tok, 1.0
            if len(tok) > 3:
                for i in range(len(tok) - 2):
                    yield "c:" + tok[i:i + 3], self.char_weight

    def _embed_one(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        for feat, w in self._features(text):
            h = _stable_hash(feat)
            idx = h % self.dim
            sign = 1.0 if (h >> 32) & 1 else -1.0
            v[idx] += sign * w
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    # ------------------------------------------------- Embeddings interface
    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        return [self._embed_one(t).tolist() for t in texts]

    def embed_query(self, text: str) -> list[float]:
        return self._embed_one(text).tolist()

    def encode_numpy(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._embed_one(t) for t in texts])
