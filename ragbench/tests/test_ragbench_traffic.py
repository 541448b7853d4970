"""The traffic generators repeat by seed, and every seed gets the same set
of sizes and gaps in another order."""

import numpy as np

from ragbench import textgen
from ragbench.traffic import open_loop

VOCAB = textgen.make_vocab(textgen.rng_for(7, "vocab"), 3000)


def docs(seed):
    return textgen.make_documents(
        textgen.rng_for(seed, "documents"), VOCAB, 1.0, 200,
        mean_words=160.8, sigma=0.75, title_words=(6, 16),
        paragraph_words=40)


def queries(seed, share=0.05):
    return textgen.make_queries(textgen.rng_for(seed, "queries"), VOCAB, 1.0,
                                400, mean_words=10.6, sigma=0.35,
                                unmatched_share=share)


def test_documents_and_queries_repeat_by_seed():
    assert docs(5) == docs(5)
    assert docs(5) != docs(6)
    assert queries(5) == queries(5)
    assert queries(5) != queries(6)


def test_sizes_are_one_set_in_another_order():
    a = sorted(len(d.split()) for d in docs(5))
    b = sorted(len(d.split()) for d in docs(6))
    assert a == b
    assert abs(np.mean(a) - 160.8) < 1.0
    qa = sorted(len(q.split()) for q in queries(5))
    assert qa == sorted(len(q.split()) for q in queries(6))


def test_unmatched_queries_hold_no_corpus_word():
    words = set(VOCAB)
    qs = queries(5, share=0.25)
    unmatched = [q for q in qs if not set(q.split()) & words]
    assert len(unmatched) == 100


def test_arrivals_repeat_and_fill_the_window():
    a = open_loop.arrival_offsets(1000, 10.0, textgen.rng_for(3, "arrivals"))
    b = open_loop.arrival_offsets(1000, 10.0, textgen.rng_for(3, "arrivals"))
    c = open_loop.arrival_offsets(1000, 10.0, textgen.rng_for(4, "arrivals"))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 10.0
    gaps_a = np.sort(np.diff(np.append(a, 10.0)))
    gaps_c = np.sort(np.diff(np.append(c, 10.0)))
    assert np.allclose(gaps_a, gaps_c)


def test_large_seed():
    s = 2 ** 31 + 987654321
    assert docs(s) == docs(s)

