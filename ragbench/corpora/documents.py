"""A document corpus of a public benchmark, generated at its published
sizes: documents of a Zipf vocabulary at the published mean length, chunked
by archi's rule, each chunk a row of the index.

The rows are standard normal vectors made on the device from the seed (the
index normalises them): the query cells measure retrieval over a store, and
the ingest cell measures the encoder over documents.  Queries are of the
same vocabulary at the published mean query length.
"""

from __future__ import annotations

import functools

import torch

from ragbench import textgen
from ragbench.reference.text import character_split
from ragbench.weights import index_rows

INSERT_BLOCK = 1 << 16


class Corpus:
    def __init__(self, config: dict, seed: int, device):
        c = config["corpus"]
        self.config, self.seed, self.device = config, int(seed), device
        self.dim = config["encoder"]["hidden_size"]
        # rows are drawn a block at a time, each block from its own stream
        self.row_block = c["row_block"]
        self.vocab = textgen.make_vocab(textgen.rng_for(seed, "vocab"),
                                        c["vocabulary_words"])
        self.zipf = c["zipf_exponent"]
        self.wp_vocab = textgen.wordpiece_vocab(
            self.vocab, config["encoder"]["vocab_size"])
        self.documents = textgen.make_documents(
            textgen.rng_for(seed, "documents"), self.vocab, self.zipf,
            c["documents"], mean_words=c["mean_document_words"],
            sigma=c["document_words_sigma"],
            title_words=tuple(c["title_words"]),
            paragraph_words=c["paragraph_words"], device=device)

    @functools.cached_property
    def chunks(self) -> list[tuple[int, int, str]]:
        """(document, chunk number, text) for every chunk, in row order."""
        a = self.config["archi"]
        return [(d, j, t) for d, doc in enumerate(self.documents)
                for j, t in enumerate(character_split(
                    doc, a["chunk_size"], a["chunk_overlap"]))]

    @property
    def n_rows(self) -> int:
        return len(self.chunks)

    @property
    def texts(self) -> list[str]:
        return [t for _, _, t in self.chunks]

    @staticmethod
    def chunk_id(doc: int, j: int) -> str:
        return f"doc{doc:06d}:{j}"

    @functools.cached_property
    def _rows_by_id(self) -> dict[str, int]:
        return {self.chunk_id(d, j): r
                for r, (d, j, _) in enumerate(self.chunks)}

    def row_of(self, chunk_id: str) -> int:
        return self._rows_by_id[chunk_id]

    def rows(self, start: int, count: int) -> torch.Tensor:
        return index_rows(self.seed, start, count, self.dim, self.device,
                          self.row_block)

    def row_blocks(self):
        """(start, count) blocks covering every row."""
        for s in range(0, self.n_rows, self.row_block):
            yield s, min(self.row_block, self.n_rows - s)

    def fill(self, store) -> None:
        """Every chunk into the store, as a deployment's ingest leaves it:
        text, id and metadata, with the row as its embedding."""
        step = min(INSERT_BLOCK, self.row_block)
        for s in range(0, self.n_rows, step):
            part = self.chunks[s:s + step]
            ids = [self.chunk_id(d, j) for d, j, _ in part]
            metas = [{"resource_hash": f"doc{d:06d}",
                      "display_name": f"doc{d:06d}.txt",
                      "source_type": "local_files"} for d, _, _ in part]
            store.add_texts([t for _, _, t in part], metas, ids=ids,
                            embeddings=self.rows(s, len(part)))

    def queries(self, n: int, unmatched_share: float) -> list[str]:
        q = self.config["queries"]
        return textgen.make_queries(
            textgen.rng_for(self.seed, "queries"), self.vocab, self.zipf, n,
            mean_words=q["mean_words"], sigma=q["words_sigma"],
            unmatched_share=unmatched_share)
