"""Self-contained BERT WordPiece tokenizer (no HF hub dependency).

Copy of ``archi_tpu/models/tokenizer.py`` (Python path only).

The reference delegates tokenization to sentence-transformers / tiktoken
(``src/archi/pipelines/classic_pipelines/utils/token_limiter.py``).  This is
a from-scratch implementation of the standard BERT tokenization pipeline
(lowercase/accent-strip basic tokenizer + greedy-longest-match WordPiece)
compatible with ``vocab.txt`` files from MiniLM/bge checkpoints.  When no
vocabulary file exists (zero-egress environments), ``build_vocab`` derives
one from the corpus so the whole stack still runs end-to-end.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Iterable

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    # P* (punctuation) and S* (symbols: €, box-drawing, arrows, math) both
    # split words; keeps the native ASCII analyzer's transliteration exact.
    return unicodedata.category(ch).startswith(("P", "S"))


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF
    )


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """Clean + whitespace/punctuation/CJK split, lowercase + strip accents."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            if ch not in ("\t", "\n", "\r"):
                continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = "".join(out)

    tokens = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        # split punctuation into separate tokens
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    """BERT-style tokenizer: ids = [CLS] wordpieces [SEP], padded by caller."""

    def __init__(self, vocab: dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 200):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    # ------------------------------------------------------------- factories
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def build_vocab(cls, texts: Iterable[str], size: int = 30522,
                    lowercase: bool = True) -> "WordPieceTokenizer":
        """Corpus-derived vocab: specials + single chars + frequent words +
        frequent suffixes (##-pieces).  Deterministic."""
        word_counts: collections.Counter = collections.Counter()
        char_counts: collections.Counter = collections.Counter()
        for t in texts:
            for w in basic_tokenize(t, lowercase):
                word_counts[w] += 1
                for c in w:
                    char_counts[c] += 1
        vocab: dict[str, int] = {}
        for s in SPECIALS:
            vocab[s] = len(vocab)
        for c, _ in sorted(char_counts.items(), key=lambda x: (-x[1], x[0])):
            for piece in (c, f"##{c}"):
                if piece not in vocab and len(vocab) < size:
                    vocab[piece] = len(vocab)
        # frequent whole words, then frequent suffix pieces
        for w, _ in sorted(word_counts.items(), key=lambda x: (-x[1], x[0])):
            if len(vocab) >= size:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        suffix_counts: collections.Counter = collections.Counter()
        for w, n in word_counts.items():
            for i in range(1, len(w)):
                if len(w) - i <= 8:
                    suffix_counts[f"##{w[i:]}"] += n
        for sfx, _ in sorted(suffix_counts.items(), key=lambda x: (-x[1], x[0])):
            if len(vocab) >= size:
                break
            if sfx not in vocab:
                vocab[sfx] = len(vocab)
        return cls(vocab, lowercase=lowercase)

    # ------------------------------------------------------------- tokenize
    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for w in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(w))
        return out

    def encode(self, text: str, max_length: int = 512) -> list[int]:
        """→ [CLS] piece-ids [SEP], truncated to max_length.

        Pure Python: the JAX package's C++ encoder gives the same ids for
        ASCII text and is not carried over."""
        ids = [self.vocab.get(p, self.unk_id) for p in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: list[str], max_length: int = 512):
        return [self.encode(t, max_length) for t in texts]

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.inv_vocab.get(i, UNK) for i in ids
                if i not in (self.pad_id, self.cls_id, self.sep_id)]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def save_vocab(self, path: str) -> None:
        items = sorted(self.vocab.items(), key=lambda x: x[1])
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in items:
                f.write(tok + "\n")
