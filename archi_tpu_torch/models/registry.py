"""Embedding model resolution — the ``embedding_class_map`` analog.

Counterpart of ``archi_tpu/models/registry.py``, with the same names:

- ``jax`` / ``huggingface`` / ``minilm`` / ``bge`` / ``tpu`` →
  ``TorchEmbedder`` (the encoder on the card; a local snapshot dir is
  honored via ``model_dir``),
- ``openai`` → an HTTP embeddings client,
- ``hash`` → deterministic offline embeddings (tests / zero-egress smoke),
- ``hashed_ngram`` → the training-free featurizer.

``HashEmbeddings``, ``OpenAIEmbeddings`` and ``read_secret`` (from
``archi_tpu/providers/base.py``) are copied.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Optional

import numpy as np

from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder


def read_secret(name: str) -> Optional[str]:
    """Secret resolution: ``NAME_FILE`` mount wins, else env var."""
    file_var = os.environ.get(f"{name}_FILE")
    if file_var and os.path.exists(file_var):
        with open(file_var) as f:
            return f.read().strip()
    return os.environ.get(name)


class OpenAIEmbeddings:
    """Remote embedding API client."""

    def __init__(self, model: str = "text-embedding-3-small", *,
                 api_key: str = "", base_url: str = "https://api.openai.com/v1",
                 dim: int = 1536, timeout: float = 60.0):
        self.model = model
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.dim = dim
        self.timeout = timeout

    def embed_documents(self, texts):
        import requests

        r = requests.post(
            f"{self.base_url}/embeddings",
            headers={"Authorization": f"Bearer {self.api_key}"},
            json={"model": self.model, "input": list(texts)},
            timeout=self.timeout,
        )
        r.raise_for_status()
        data = sorted(r.json()["data"], key=lambda d: d["index"])
        return [d["embedding"] for d in data]

    def embed_query(self, text):
        return self.embed_documents([text])[0]


class HashEmbeddings:
    """Deterministic offline embeddings (bag of hashed words, unit norm)."""

    def __init__(self, dim: int = 384):
        self.dim = dim

    def _vec(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        for tok in text.lower().split():
            h = int.from_bytes(
                hashlib.md5(tok.encode()).digest()[:8], "little"
            )
            rs = np.random.RandomState(h % (2**31))
            v += rs.standard_normal(self.dim).astype(np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v + 1.0 / np.sqrt(self.dim)

    def embed_documents(self, texts):
        return [self._vec(t).tolist() for t in texts]

    def embed_query(self, text):
        return self._vec(text).tolist()


def resolve_embedder(dm_config: dict[str, Any], *, device=None):
    """data_manager config section → embedding object.  ``device`` is the
    encoder's (``TorchEmbedder``: cuda by default, raising without it)."""
    name = (dm_config.get("embedding_name")
            or dm_config.get("embedding_class", "jax")).lower()
    kw = dict(dm_config.get("embedding_kwargs", {}) or {})
    if name in ("jax", "huggingface", "huggingfaceembeddings", "minilm",
                "bge", "tpu"):
        return TorchEmbedder(
            model_dir=kw.get("model_dir") or dm_config.get("model_dir"),
            max_length=kw.get("max_length", 256),
            instruction_prefix=kw.get("instruction_prefix", ""),
            pooling=kw.get("pooling"),
            device=device,
        )
    if name in ("openai", "openaiembeddings"):
        return OpenAIEmbeddings(
            model=kw.get("model", "text-embedding-3-small"),
            api_key=kw.get("api_key") or read_secret("OPENAI_API_KEY") or "",
            base_url=kw.get("base_url", "https://api.openai.com/v1"),
        )
    if name in ("hash", "fake", "test"):
        return HashEmbeddings(dim=kw.get("dim", 384))
    if name in ("hashed_ngram", "featurizer"):
        # deterministic training-free featurizer (quality-fixture embedder)
        return HashedNgramEmbedder(dim=kw.get("dim", 384))
    raise ValueError(f"unknown embedding class: {name}")
