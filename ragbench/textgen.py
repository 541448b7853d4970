"""Text inputs made from the seed: a Zipf vocabulary, documents, queries and
the WordPiece vocabulary both sides tokenize with.

Every size is drawn as a fixed set of quantiles and only its order comes
from the seed, so two seeds give the same amount of work in another order.
The words themselves (which terms a query or document holds) come from the
seed.
"""

from __future__ import annotations

import numpy as np
import torch

#: the analyzer's stopwords rank first, as the most frequent English words do
STOPWORDS = tuple(
    "the of and to in a is for that with on as by are be this was it at "
    "or an not from their these such into no then there they if but will"
    .split())
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """One independent generator per named stream of a seed."""
    key = [ord(c) for c in stream]
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  *key])


def make_vocab(rng: np.random.Generator, n_words: int) -> list[str]:
    """Word types by Zipf rank: the stopwords, then random lowercase words
    of 3-12 letters (mean about 6.5), all distinct."""
    out = list(STOPWORDS)
    seen = set(out)
    while len(out) < n_words:
        need = n_words - len(out)
        lens = np.clip(np.rint(rng.normal(6.5, 2.0, need)), 3, 12).astype(int)
        chars = LETTERS[rng.integers(0, 26, (need, 12))]
        for row, n in zip(chars, lens):
            w = row[:n].tobytes().decode()
            if w not in seen:
                seen.add(w)
                out.append(w)
    return out[:n_words]


def zipf_ranks(u: np.ndarray, n_words: int, exponent: float) -> np.ndarray:
    """Word ranks (0 = most frequent) at quantiles u of a Zipf law over
    n_words types: the continuous law of density x^-exponent on
    [1, n_words + 1), by its inverse distribution function, floored."""
    top = float(n_words + 1)
    if abs(exponent - 1.0) < 1e-12:
        x = np.exp(u * np.log(top))
    else:
        a = 1.0 - exponent
        x = (u * top ** a + (1.0 - u)) ** (1.0 / a)
    return np.clip(x.astype(np.int64) - 1, 0, n_words - 1)


def draw_words(rng: np.random.Generator, n_words: int, exponent: float,
               n: int) -> np.ndarray:
    """n word ranks drawn at random from the Zipf law."""
    return zipf_ranks(rng.random(n), n_words, exponent)


def quantile_lengths(rng: np.random.Generator, n: int, mean: float,
                     sigma: float, lo: int, hi: int) -> np.ndarray:
    """n lognormal lengths of the given mean, as fixed quantiles clipped to
    [lo, hi] and rescaled so that the clipped set keeps the mean; the seed
    only orders them."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    z = torch.special.ndtri(torch.from_numpy(u)).numpy()
    x = np.exp(sigma * z)
    x = np.clip(x * mean / x.mean(), lo, hi)
    x = np.clip(x * mean / x.mean(), lo, hi)
    lengths = np.maximum(np.rint(x).astype(np.int64), lo)
    return lengths[rng.permutation(n)]


def _join(words: np.ndarray, ids: np.ndarray) -> str:
    return " ".join(words[ids].tolist())


def make_documents(rng: np.random.Generator, vocab: list[str],
                   exponent: float, n_docs: int, *, mean_words: float,
                   sigma: float, title_words: tuple[int, int],
                   paragraph_words: float, device="cpu") -> list[str]:
    """Documents as a title and paragraphs, separated by blank lines (the
    separator archi's chunker splits on); a paragraph ends after a word
    with probability 1 / paragraph_words.  The title counts in the
    document's words.  Built as one byte string and cut, not word by
    word."""
    lengths = quantile_lengths(rng, n_docs, mean_words, sigma,
                               title_words[1] + 1, 20 * int(mean_words))
    starts = np.concatenate([[0], np.cumsum(lengths)])
    ids = draw_words(rng, len(vocab), exponent, int(starts[-1]))
    brk = rng.random(len(ids)) < 1.0 / paragraph_words
    brk[starts[:-1] + rng.integers(title_words[0], title_words[1] + 1,
                                   n_docs) - 1] = True
    brk[starts[1:] - 1] = True          # the document's end: cut off below
    width = np.fromiter((len(w) for w in vocab), np.int64, len(vocab))
    table = np.zeros((len(vocab), int(width.max()) + 2), np.uint8)
    for i, w in enumerate(vocab):
        table[i, :len(w)] = np.frombuffer(w.encode(), np.uint8)
    # each word's bytes, then " " or "\n\n", gathered and packed on the
    # device (the same bytes on any device)
    ids_t = torch.from_numpy(ids).to(device)
    brk_t = torch.from_numpy(brk).to(device)
    wl = torch.from_numpy(width).to(device)[ids_t]
    cells = torch.from_numpy(table).to(device)[ids_t]
    n = torch.arange(len(ids), device=device)
    cells[n, wl] = torch.where(brk_t, 10, 32).to(torch.uint8)
    cells[n[brk_t], wl[brk_t] + 1] = 10
    used = wl + 1 + brk_t
    keep = torch.arange(cells.shape[1], device=device)[None, :] < used[:, None]
    big = cells[keep].cpu().numpy().tobytes()
    del cells, keep
    ends = torch.cumsum(used, 0).cpu().numpy()
    first = np.concatenate([[0], ends[starts[1:-1] - 1]])
    last = ends[starts[1:] - 1] - 2
    return [big[a:b].decode() for a, b in zip(first.tolist(), last.tolist())]


def make_queries(rng: np.random.Generator, vocab: list[str], exponent: float,
                 n: int, *, mean_words: float, sigma: float,
                 unmatched_share: float = 0.0) -> list[str]:
    """Queries of the corpus vocabulary; a share of them (a fixed count
    whose places come from the seed) are of words no document holds (a
    digit in each), so that the lexical side matches nothing.  Every seed
    draws the same multiset of word ranks, in its own order."""
    words = np.asarray(vocab, dtype=object)
    lengths = quantile_lengths(rng, n, mean_words, sigma, 1,
                               max(4, int(4 * mean_words)))
    # the words' ranks are one fixed set of Zipf quantiles, in the seed's
    # order: every seed asks for postings of the same lengths
    m = int(lengths.sum())
    ids = zipf_ranks((np.arange(m) + 0.5) / m, len(vocab),
                     exponent)[rng.permutation(m)]
    n_unmatched = int(round(unmatched_share * n))
    unmatched = set(rng.permutation(n)[:n_unmatched].tolist())
    out, pos = [], 0
    for i, ln in enumerate(lengths.tolist()):
        q_ids = ids[pos:pos + ln]
        pos += ln
        if i in unmatched:
            digits = rng.integers(0, 10, ln)
            out.append(" ".join(f"{words[j][:4]}{d}"
                                for j, d in zip(q_ids.tolist(),
                                                digits.tolist())))
        else:
            out.append(_join(words, q_ids))
    return out


def wordpiece_vocab(vocab: list[str], size: int) -> dict[str, int]:
    """A WordPiece vocabulary at the encoder's size: the specials, every
    letter and digit alone and as a ``##`` piece, then whole words by
    rank.  No ``vocab.txt`` is in the repository; this stands in for the
    published one, built from the corpus's own word list."""
    pieces = list(SPECIALS)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        pieces += [c, "##" + c]
    seen = set(pieces)
    for w in vocab:
        if len(pieces) >= size:
            break
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    return {p: i for i, p in enumerate(pieces)}
