"""Plain reference of archi's text handling: the chunker, the lexical
analyzer, BM25 and WordPiece, written from their published rules.

Frozen here so that the yardstick does not move with the program.  Only
ASCII text is handled, which is all the benchmark generates: lowercase,
whitespace split, ASCII punctuation split off as tokens of its own.
"""

from __future__ import annotations

import math
import re
from collections import Counter

import torch

#: the analyzer's stopword list (Lucene's English set)
STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())
_WORD = re.compile(r"[^\s!-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")


def basic_tokens(text: str) -> list[str]:
    return _WORD.findall(text.lower())


def analyze(text: str) -> list[str]:
    """BM25 terms: lowercase tokens of two or more characters, letters or
    digits only, not all digits, not a stopword."""
    return [t for t in basic_tokens(text)
            if len(t) > 1 and t.isalnum() and not t.isdigit()
            and t not in STOPWORDS]


def character_split(text: str, chunk_size: int = 1000,
                    chunk_overlap: int = 0, separator: str = "\n\n"
                    ) -> list[str]:
    """LangChain's CharacterTextSplitter rule as archi configures it: split
    on the separator, cut any piece longer than chunk_size, merge pieces
    greedily up to chunk_size (joined by the separator), keep trailing
    pieces up to chunk_overlap, strip, drop empty chunks."""
    if not text:
        return []
    pieces = text.split(separator) if separator else list(text)
    cut = []
    for p in pieces:
        while len(p) > chunk_size:
            cut.append(p[:chunk_size])
            p = p[chunk_size:]
        cut.append(p)
    sep = len(separator)
    chunks, cur, cur_len = [], [], 0
    for p in cut:
        if cur and cur_len + len(p) + sep > chunk_size:
            chunks.append(separator.join(cur))
            kept, kept_len = [], 0
            for q in reversed(cur if chunk_overlap > 0 else []):
                add = len(q) + (sep if kept else 0)
                if kept_len + add > chunk_overlap:
                    break
                kept.insert(0, q)
                kept_len += add
            cur, cur_len = kept, kept_len
        cur_len += len(p) + (sep if cur else 0)
        cur.append(p)
    if cur:
        chunks.append(separator.join(cur))
    return [c for c in (c.strip() for c in chunks) if c]


class BM25:
    """Okapi BM25 (k1 1.2, b 0.75, idf ln(1 + (N - df + 0.5) / (df + 0.5)))
    over a list of texts, keeping postings only for the terms asked for."""

    def __init__(self, texts, terms, k1: float = 1.2, b: float = 0.75):
        self.k1, self.b = k1, b
        wanted = set(terms)
        self.postings: dict[str, dict[int, int]] = {t: {} for t in wanted}
        self.doc_len = []
        for row, text in enumerate(texts):
            toks = analyze(text)
            self.doc_len.append(len(toks))
            for t, f in Counter(x for x in toks if x in wanted).items():
                self.postings[t][row] = f
        self.n = len(self.doc_len)
        self.avgdl = (sum(self.doc_len) / self.n) if self.n else 1.0

    def scores(self, query: str) -> dict[int, float]:
        """Row -> BM25 score, for the rows that hold a query term."""
        out: dict[int, float] = {}
        for t in set(analyze(query)):
            plist = self.postings.get(t)
            if not plist:
                continue
            df = len(plist)
            idf = math.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            for row, tf in plist.items():
                norm = self.k1 * (1.0 - self.b + self.b * self.doc_len[row]
                                  / self.avgdl)
                out[row] = out.get(row, 0.0) + idf * tf * (self.k1 + 1.0) / (
                    tf + norm)
        return out


class WordPiece:
    """BERT WordPiece: basic tokens, greedy longest match with ``##``
    continuation pieces, a word with no match as [UNK], then
    [CLS] ids [SEP] cut to max_length."""

    def __init__(self, vocab: dict[str, int], max_chars_per_word: int = 200):
        self.vocab = vocab
        self.max_chars = max_chars_per_word
        self.unk, self.cls, self.sep = (vocab["[UNK]"], vocab["[CLS]"],
                                        vocab["[SEP]"])

    def word(self, w: str) -> list[int]:
        if len(w) > self.max_chars:
            return [self.unk]
        out, start = [], 0
        while start < len(w):
            end = len(w)
            while end > start:
                piece = w[start:end] if start == 0 else "##" + w[start:end]
                if piece in self.vocab:
                    out.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk]
            start = end
        return out

    def encode(self, text: str, max_length: int) -> list[int]:
        ids = []
        for w in basic_tokens(text):
            ids.extend(self.word(w))
        return [self.cls] + ids[:max_length - 2] + [self.sep]


_PACK_CHARS = 12   # letters a word of the generated texts has at most


def _pack(word: str):
    """A lowercase word of at most 12 letters as an exact 60-bit integer
    (5 bits a letter); None for any other term."""
    if not (0 < len(word) <= _PACK_CHARS and word.isascii()
            and word.isalpha() and word.islower()):
        return None
    key = 0
    for j, ch in enumerate(word):
        key |= (ord(ch) - 96) << (5 * j)
    return key


def bm25_dense(texts: list[str], queries: list[str], device, *,
               k1: float = 1.2, b: float = 0.75):
    """Each query's BM25 score of every text, [len(queries), len(texts)]
    float64 on ``device``, by the same rule as ``BM25``.  Texts of lowercase
    words of at most 12 letters between spaces and newlines (what the
    benchmark generates) are counted with tensors, each word packed into an
    exact integer; any other text takes ``BM25``."""
    joined = "\n".join(texts).encode()
    raw = torch.frombuffer(bytearray(joined), dtype=torch.uint8).to(device)
    space = (raw == 32) | (raw == 10)
    letter = (raw >= 97) & (raw <= 122)
    edge = torch.ones(1, dtype=torch.bool, device=device)
    starts = torch.nonzero(~space & torch.cat([edge, space[:-1]])).flatten()
    ends = torch.nonzero(~space & torch.cat([space[1:], edge])).flatten() + 1
    length = ends - starts
    if not bool((space | letter).all()) or (
            len(length) and int(length.max()) > _PACK_CHARS):
        slow = BM25(texts, {t for q in queries for t in analyze(q)}, k1, b)
        out = torch.zeros((len(queries), len(texts)), dtype=torch.float64)
        for i, q in enumerate(queries):
            for row, v in slow.scores(q).items():
                out[i, row] = v
        return out.to(device)
    key = torch.zeros(len(starts), dtype=torch.int64, device=device)
    for j in range(_PACK_CHARS):
        at = (starts + j).clamp(max=len(raw) - 1)
        key += torch.where(length > j, (raw[at].long() - 96) << (5 * j), 0)
    lens = torch.tensor([len(t) + 1 for t in texts], device=device)
    first = torch.cumsum(lens, 0) - lens
    row = torch.searchsorted(first, starts, right=True) - 1
    stop = torch.tensor([_pack(w) for w in STOPWORDS], device=device)
    keep = (length >= 2) & ~torch.isin(key, stop)
    n = len(texts)
    dl = torch.bincount(row[keep], minlength=n).double()
    avgdl = float(dl.sum()) / n if n else 1.0
    q_terms = [[_pack(t) for t in set(analyze(q))] for q in queries]
    wanted = sorted({t for ts in q_terms for t in ts if t is not None})
    out = torch.zeros((len(queries), n), dtype=torch.float64, device=device)
    if not wanted:
        return out
    wanted_t = torch.tensor(wanted, device=device)
    sel = keep & torch.isin(key, wanted_t)
    term = torch.searchsorted(wanted_t, key[sel])
    pair, tf = torch.unique(term * n + row[sel], return_counts=True)
    p_term, p_row = pair // n, pair % n
    df = torch.bincount(p_term, minlength=len(wanted))
    lo = torch.searchsorted(p_term, torch.arange(len(wanted), device=device))
    hi = torch.searchsorted(p_term, torch.arange(len(wanted), device=device),
                            right=True)
    index = {t: i for i, t in enumerate(wanted)}
    for qi, ts in enumerate(q_terms):
        for t in ts:
            if t is None:
                continue
            i = index[t]
            a, z = int(lo[i]), int(hi[i])
            if a == z:
                continue
            d = int(df[i])
            idf = math.log(1.0 + (n - d + 0.5) / (d + 0.5))
            f = tf[a:z].double()
            r = p_row[a:z]
            norm = k1 * (1.0 - b + b * dl[r] / avgdl)
            out[qi].index_add_(0, r, idf * f * (k1 + 1.0) / (f + norm))
    return out
