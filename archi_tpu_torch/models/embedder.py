"""Batched, bucketed embedding inference.

Counterpart of ``archi_tpu/models/embedder.py`` (``JaxEmbedder``): the
LangChain ``Embeddings`` contract (``embed_documents`` / ``embed_query``)
over the PyTorch encoder (``archi_tpu_torch.models.bert``).  Sequences are
padded into the same (batch, seq) buckets, grouped by sequence bucket, and
pad rows are fully masked.  Sharding over several devices is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from archi_tpu_torch.models.bert import BertConfig, BertEncoder, encode
from archi_tpu_torch.models.hf_loader import load_or_init
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
from archi_tpu_torch.utils.hardware import default_device

SEQ_BUCKETS = (64, 128, 256, 512)
BATCH_BUCKETS = (8, 32, 128, 256)


def _bucket_up(x: int, buckets) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


class TorchEmbedder:
    """Text → normalized embedding vectors on the card.

    Args:
      model_dir: local HF snapshot dir (config.json + weights + vocab.txt);
        falls back to deterministic random weights + an ASCII char vocab.
      config: explicit BertConfig override (ignored if model_dir loads).
      device: defaults to ``cuda`` (raises without CUDA); pass ``"cpu"``
        to run on the CPU.
      compute_dtype: defaults to bf16 on the card, f32 elsewhere.
      instruction_prefix: prepended to queries only.
      seed: seed of the random weights when no snapshot loads.
    """

    def __init__(
        self,
        model_dir: str | None = None,
        config: BertConfig | None = None,
        tokenizer: WordPieceTokenizer | None = None,
        *,
        device=None,
        compute_dtype: torch.dtype | None = None,
        max_length: int = 256,
        instruction_prefix: str = "",
        pooling: str | None = None,
        seed: int = 0,
    ):
        self.device = default_device(device)
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                             else torch.float32)
        if pooling is None:
            # bge-family checkpoints use CLS pooling; MiniLM et al. mean-pool
            pooling = "cls" if "bge" in (model_dir or "").lower() else "mean"
        self.config, state, vocab_path = load_or_init(
            model_dir, config, pooling=pooling, seed=seed)
        self.model = BertEncoder.from_state(
            self.config, state, device=self.device, compute_dtype=compute_dtype)
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif vocab_path:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path)
        else:
            # Vocab-less fallback: ASCII char-level vocab; deterministic.
            chars = [chr(c) for c in range(32, 127)]
            self.tokenizer = WordPieceTokenizer.build_vocab(
                ["".join(chars)], size=max(512, self.config.vocab_size))
        self.compute_dtype = compute_dtype
        self.max_length = min(max_length, self.config.max_position_embeddings)
        self.instruction_prefix = instruction_prefix

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    # ----------------------------------------------------------------- core
    def _pad_batch(self, id_lists: list[list[int]]):
        """Pad a group of token-id lists into one (batch, seq) bucket."""
        seq = _bucket_up(max(len(i) for i in id_lists), SEQ_BUCKETS)
        seq = min(seq, self.max_length)
        bsz = _bucket_up(len(id_lists), BATCH_BUCKETS)
        ids = np.zeros((bsz, seq), np.int64)
        mask = np.zeros((bsz, seq), np.int64)
        for r, lst in enumerate(id_lists):
            lst = lst[:seq]
            ids[r, : len(lst)] = lst
            mask[r, : len(lst)] = 1
        # pad rows stay fully masked
        return ids, mask

    def encode_ids(self, id_lists: list[list[int]]) -> np.ndarray:
        """Token-id lists → [n, H] f32 embeddings."""
        out = np.zeros((len(id_lists), self.dim), np.float32)
        # group by sequence bucket, at most one batch bucket per group
        order = np.argsort([len(i) for i in id_lists], kind="stable")
        groups: list[list[int]] = []
        pos = 0
        while pos < len(order):
            seq_b = _bucket_up(len(id_lists[order[pos]]), SEQ_BUCKETS)
            group = [order[pos]]
            pos += 1
            while (
                pos < len(order)
                and _bucket_up(len(id_lists[order[pos]]), SEQ_BUCKETS) == seq_b
                and len(group) < BATCH_BUCKETS[-1]
            ):
                group.append(order[pos])
                pos += 1
            groups.append(group)
        # launch every group first (the device runs ahead of the host), then
        # collect
        pending = []
        for group in groups:
            ids, mask = self._pad_batch([id_lists[g] for g in group])
            pending.append((group, encode(
                self.model, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))))
        for group, emb in pending:
            out[np.asarray(group)] = emb[: len(group)].cpu().numpy()
        return out

    # ------------------------------------------------- Embeddings interface
    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        if not texts:
            return []
        return self.encode_numpy(texts).tolist()

    def embed_query(self, text: str) -> list[float]:
        if self.instruction_prefix:
            text = self.instruction_prefix + text
        return self.embed_documents([text])[0]

    def encode_numpy(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        id_lists = [self.tokenizer.encode(t, self.max_length) for t in texts]
        return self.encode_ids(id_lists)
