"""The port's native text analyzer (``archi_tpu_torch.native``) against the
JAX package's.

The port's ``analyze`` (BM25 terms) and ``WordPieceTokenizer.encode`` equal
the JAX package's on the same texts, both packages taking their C++ route
where they would (ASCII, transliterated Latin) and their Python route
elsewhere (non-Latin scripts); the port's native and Python routes agree;
8 threads calling the library at once get the single-threaded results; the
library builds into ``archi_tpu_torch/_build/`` and a failed build leaves
the Python route with the same output.  Skips where there is no ``g++``.
"""

import os
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from archi_tpu.engine.bm25 import analyze as jax_analyze
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch import native
from archi_tpu_torch.engine.bm25 import STOPWORDS, BM25Index, analyze
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer


JAX_BUILD = {}     # the JAX library's shared and private paths


def _file_state(path):
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_size, st.st_mtime_ns


@pytest.fixture(scope="module", autouse=True)
def lib(tmp_path_factory):
    """The port's library, and the JAX package's C++ route loaded from a
    private build.

    The JAX loader compiles straight into ``archi_tpu/native/
    libtext_analyzer.so`` and keeps its first failed load for the life of
    the process, so a test worker that loads that shared path while
    another writes it keeps the Python route.  This module compiles the
    same source with the JAX loader's flags into its own directory, points
    the loader there for the module's tests, and restores the loader's
    three globals exactly as they were afterwards.
    """
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    lib = native.load_library()
    assert lib is not None, "g++ is present but the library did not build"
    import archi_tpu.native as jax_native

    JAX_BUILD.update(shared=jax_native._SO,
                     shared_before=_file_state(jax_native._SO))
    so = str(tmp_path_factory.mktemp("jax_native") / "libtext_analyzer.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    jax_native._SRC, "-o", so],
                   check=True, capture_output=True, timeout=120)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", so)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.load_library() is not None
        JAX_BUILD["private"] = so
        yield lib


ASCII = [
    "The quick brown Fox jumps over the lazy dog!",
    "Running, jumped, and flies: relational conditionals " * 3,
    "numbers 123 456 mixed a1b2 x,y;z",
    "   lots   of\twhitespace\nand\r\nnewlines  ",
    "punct...only!!! ??? ---",
    "",
    "a",
    "GPU partitions require approval; quotas are 100GB per user.",
    "control\x01chars\x07dropped but\ttabs kept",
    "word " * 500,
]
# Latin text and symbols that transliterate to ASCII (the C++ route)
LATIN = ["café naïve résumé", "jobs — “quoted” │ queue", "déjà vu, señor",
         "naïveté’s coöperation", "™ © ® ° § ¶ 1,234.56 $ 7%"]
# texts only the Python route takes: non-Latin scripts, letters without an
# ASCII base (ß, Æ, ø), symbols past the transliteration table
NON_LATIN = ["日本語のテキスト", "Привет мир, как дела", "Ελληνικά κείμενα",
             "mixed 中文 and ascii words", "Ångström über straße Ærø façade",
             "price € 100 → 200 ± 5 x² ≤ y"]
ALL = ASCII + LATIN + NON_LATIN
CORPUS = ASCII + LATIN + [
    "submit slurm array jobs with sbatch on the batch cluster partition",
    "xrootd transfer timeout when copying files with xrdcp redirector",
    "kubernetes pod eviction due to node memory pressure limits"]


def _python_analyze(text, stemming):
    # another object than the default stopwords takes the Python route
    return analyze(text, stemming=stemming, stopwords=set(STOPWORDS))


def _without_nul_and_del(text):
    return text.replace("\x00", "").replace("\x7f", "")


@pytest.fixture(scope="module")
def tokenizers():
    port = WordPieceTokenizer.build_vocab(CORPUS, size=400)
    jax_tok = JaxTokenizer(dict(port.vocab))
    python = WordPieceTokenizer(dict(port.vocab))
    python._native = None          # the Python route only
    return port, jax_tok, python


@pytest.mark.parametrize("stemming", [False, True])
@pytest.mark.parametrize("text", ALL, ids=lambda t: t[:24])
def test_analyze_matches_jax(text, stemming):
    assert analyze(text, stemming=stemming) == \
        jax_analyze(text, stemming=stemming)


@pytest.mark.parametrize("stemming", [False, True])
@pytest.mark.parametrize("text", ALL, ids=lambda t: t[:24])
def test_analyze_native_and_python_routes_agree(text, stemming):
    assert analyze(text, stemming=stemming) == _python_analyze(text, stemming)


@pytest.mark.parametrize("max_length", [4, 16, 64, 512])
@pytest.mark.parametrize("text", ALL, ids=lambda t: t[:24])
def test_encode_matches_jax_and_the_python_route(tokenizers, text,
                                                 max_length):
    port, jax_tok, python = tokenizers
    got = port.encode(text, max_length)
    assert got == jax_tok.encode(text, max_length)
    assert got == python.encode(text, max_length)
    assert len(got) <= max_length


def test_routes_are_counted(tokenizers):
    port = tokenizers[0]
    native.reset_routes()
    for t in ASCII + LATIN:
        analyze(t)
    for t in NON_LATIN:
        analyze(t)
    for t in ASCII:
        port.encode(t, 64)
    for t in LATIN + NON_LATIN:
        port.encode(t, 64)
    assert native.ROUTES == {
        "analyze:native": len(ASCII + LATIN),
        "analyze:python": len(NON_LATIN),
        "analyze:native_batch": 0,
        "encode:native": len(ASCII),
        "encode:python": len(LATIN + NON_LATIN)}
    analyze("plain words", stopwords=frozenset({"plain"}))
    assert native.ROUTES["analyze:python"] == len(NON_LATIN) + 1
    native.reset_routes()
    assert not any(native.ROUTES.values())


ASCII_TEXT = st.text(
    alphabet=st.characters(min_codepoint=0, max_codepoint=127), max_size=200)


# NUL and DEL reach the reference's C++ unchanged (test below); on the
# texts without them both packages' routes give one output


@settings(max_examples=100, deadline=None)
@given(text=ASCII_TEXT, stemming=st.booleans())
def test_random_ascii_matches_jax_and_python(text, stemming):
    got = analyze(text, stemming=stemming)
    assert got == jax_analyze(_without_nul_and_del(text), stemming=stemming)
    assert got == _python_analyze(text, stemming)


@settings(max_examples=100, deadline=None)
@given(text=ASCII_TEXT, max_length=st.integers(min_value=2, max_value=96))
def test_random_ascii_encode_matches_jax(tokenizers, text, max_length):
    port, jax_tok, python = tokenizers
    got = port.encode(text, max_length)
    assert got == jax_tok.encode(_without_nul_and_del(text), max_length)
    assert got == python.encode(text, max_length)


def _terms_of(ids, counts, vocab):
    ends = np.cumsum(counts)
    return [[vocab[i] for i in ids[end - n:end]]
            for n, end in zip(counts, ends)]


@settings(max_examples=60, deadline=None)
@given(texts=st.lists(ASCII_TEXT, max_size=6), stemming=st.booleans())
def test_batched_analyzer_gives_the_terms_of_analyze_as_ids(texts, stemming):
    """``NativeTermIds.analyze`` of a batch gives, text by text, the ids
    of the terms ``analyze`` gives; terms pushed before keep their ids, new
    ones take the next ids in the order they occur; the batch's texts are
    counted on the ``analyze:native_batch`` route."""
    table = native.NativeTermIds()
    pushed = ["quota", "jobs"]
    table.push(pushed)
    before = dict(native.ROUTES)
    ids, counts, new = table.analyze(
        [native.prepare_for_native(t) for t in texts], stemming=stemming)
    assert native.ROUTES["analyze:native_batch"] == \
        before["analyze:native_batch"] + len(texts)
    assert native.ROUTES["analyze:native"] == before["analyze:native"]
    want = [analyze(t, stemming=stemming) for t in texts]
    assert _terms_of(ids, counts, pushed + new) == want
    assert new == list(dict.fromkeys(
        t for terms in want for t in terms if t not in pushed))
    assert table.size == len(pushed) + len(new)


@pytest.mark.parametrize("route", ["use_native_false", "no_compiler"])
def test_python_route_builds_the_same_index(route, monkeypatch, tmp_path):
    """An index filled in batches that mix both routes, and the same index
    filled through the Python route alone, save the same bytes (terms,
    ids, postings, lengths) and score alike."""
    texts = ALL + CORPUS
    rows = list(range(len(texts)))
    queries = ["quick fox", "café", "日本語のテキスト", "jobs queue"]

    def fill(name):
        idx = BM25Index(device="cpu")
        idx.add(rows[:9], texts[:9])
        idx.add(rows[9:], texts[9:])
        idx.save(str(tmp_path / name))
        return [idx.scores(q, 32) for q in queries]

    native.reset_routes()
    want = fill("native.json")
    assert native.ROUTES["analyze:native_batch"] == len(ASCII + LATIN + CORPUS)
    # the texts and one query only the Python route takes
    assert native.ROUTES["analyze:python"] == len(NON_LATIN) + 1
    native.reset_routes()
    if route == "use_native_false":
        previous = native.use_native(False)
        try:
            got = fill("python.json")
        finally:
            native.use_native(previous)
    else:
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setenv("PATH", str(tmp_path))
        got = fill("python.json")
        assert native.load_library() is None
    assert native.ROUTES["analyze:native_batch"] == 0
    assert native.ROUTES["analyze:python"] == len(texts) + len(queries)
    assert (tmp_path / "python.json").read_bytes() == \
        (tmp_path / "native.json").read_bytes()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("text", ["ab\x7fcd quota", "ab\x00cd quota",
                                  "\x00 leading nul", "tail del\x7f"])
def test_nul_and_del_are_dropped_as_the_python_route_drops_them(
        tokenizers, text):
    """The Python route drops NUL and DEL (control characters); the C++
    stops at a NUL and keeps DEL inside a word.  The port removes both
    before the call, so its routes agree; the reference's native route
    differs from its own Python route on these texts."""
    port, jax_tok, python = tokenizers
    assert analyze(text) == _python_analyze(text, False) == \
        jax_analyze(_without_nul_and_del(text))
    assert port.encode(text, 32) == python.encode(text, 32) == \
        jax_tok.encode(_without_nul_and_del(text), 32)
    from archi_tpu.engine.bm25 import STOPWORDS as JAX_STOPWORDS

    jax_python = jax_analyze(text, stopwords=set(JAX_STOPWORDS))
    assert jax_python == analyze(text)
    assert jax_analyze(text) != jax_python


def test_use_native_sends_every_call_to_the_python_route(tokenizers):
    port = tokenizers[0]
    want = [(analyze(t), port.encode(t, 64)) for t in ALL]
    native.reset_routes()
    assert native.use_native(False) is True
    try:
        got = [(analyze(t), port.encode(t, 64)) for t in ALL]
    finally:
        assert native.use_native(True) is False
    assert got == want
    assert native.ROUTES == {"analyze:native": 0, "analyze:python": len(ALL),
                             "analyze:native_batch": 0,
                             "encode:native": 0, "encode:python": len(ALL)}


def test_threads_get_the_single_threaded_results(tokenizers):
    port = tokenizers[0]
    rng = np.random.default_rng(0)
    words = sorted({w for t in CORPUS for w in t.split()})
    texts = [" ".join(rng.choice(words, int(rng.integers(1, 120))))
             for _ in range(64)]
    want = [(analyze(t), analyze(t, stemming=True), port.encode(t, 96))
            for t in texts]
    got = [[] for _ in range(8)]
    start = threading.Barrier(8)

    def worker(w):
        start.wait()
        for _ in range(5):
            for t in texts:
                got[w].append((analyze(t), analyze(t, stemming=True),
                               port.encode(t, 96)))

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for w in range(8):
        assert got[w] == want * 5


def test_library_builds_into_the_build_directory():
    pkg = os.path.dirname(os.path.dirname(native.__file__))
    assert native.lib_path() == os.path.join(pkg, "_build",
                                             "libtext_analyzer.so")
    assert os.path.exists(native.lib_path())
    here = os.listdir(os.path.dirname(native.__file__))
    assert not [f for f in here if f.endswith(".so")]


def test_jax_route_is_loaded_from_the_private_build():
    import archi_tpu.native as jax_native

    assert jax_native._SO == JAX_BUILD["private"] != JAX_BUILD["shared"]
    assert jax_native._lib is not None
    assert jax_native._lib._name == JAX_BUILD["private"]
    assert jax_analyze("Private Builds") == ["private", "builds"]
    # the shared library was neither written nor removed
    assert _file_state(JAX_BUILD["shared"]) == JAX_BUILD["shared_before"]


def test_stale_library_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    so = tmp_path / "libtext_analyzer.so"
    so.write_bytes(b"not a library")
    old = os.path.getmtime(native._SRC) - 100
    os.utime(so, (old, old))
    lib = native.load_library()
    assert lib is not None and os.path.getsize(so) > 1000
    assert native.native_analyze("Rebuilt Library") == ["rebuilt", "library"]


def test_without_a_compiler_the_python_route_serves(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.load_library() is None
    assert native.native_analyze("some words") is None
    text = "The Quick brown fox, café"
    assert analyze(text) == jax_analyze(text) == ["quick", "brown", "fox",
                                                  "cafe"]
    tok = WordPieceTokenizer.build_vocab(CORPUS, size=400)
    assert tok._native_encoder() is None
    assert tok.encode(CORPUS[0], 32) == JaxTokenizer(dict(tok.vocab)).encode(
        CORPUS[0], 32)
    assert not os.listdir(tmp_path)
