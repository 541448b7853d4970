"""Native (C++) text analysis: build + ctypes bindings.

Counterpart of ``archi_tpu/native/__init__.py``.  ``text_analyzer.cc``
holds the BM25 analyzer (``ta_analyze``, the JAX package's), its batched
form for ingest, which returns term ids from a table of its own (``ti_*``,
``NativeTermIds``), and the WordPiece encoder (``wp_create`` /
``wp_encode`` / ``wp_free``), the per-document loops of ingest.  It is
compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``archi_tpu_torch/_build/libtext_analyzer.so`` (never at import, never
beside the source), and rebuilt when the source is newer than the library.
If the build or the load fails (no toolchain), ``load_library`` returns None
and every consumer takes the pure-Python path, which gives the same output.
Non-ASCII inputs take the Python path too (after a transliteration that
keeps the analyzer's output unchanged), so Unicode normalisation lives in
one implementation.

``ROUTES`` counts which path each ``analyze`` and ``encode`` call took
(``"analyze:native"``, ``"analyze:python"``, ``"encode:native"``,
``"encode:python"``) and the texts a ``NativeTermIds`` analysed
(``"analyze:native_batch"``), so a run can show that its ASCII documents
went through the library; ``use_native(False)`` sends every call to the
Python route, to measure one route against the other.  The entry points keep
no state between calls besides the read-only vocabulary of a
``NativeWordPiece`` and the table of a ``NativeTermIds`` (which its owner
mutates under its own lock), so threads may call them at once; ctypes
releases the GIL for the duration of each call.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "text_analyzer.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

ROUTES: dict[str, int] = {"analyze:native": 0, "analyze:python": 0,
                          "analyze:native_batch": 0,
                          "encode:native": 0, "encode:python": 0}
_routes_lock = threading.Lock()
_native_on = True


def count_route(route: str, n: int = 1) -> None:
    with _routes_lock:
        ROUTES[route] += n


def reset_routes() -> None:
    with _routes_lock:
        for route in ROUTES:
            ROUTES[route] = 0


def use_native(on: bool) -> bool:
    """Let the C++ route serve (the default) or send every call to the
    Python route; returns the previous setting."""
    global _native_on
    previous, _native_on = _native_on, on
    return previous


def lib_path() -> str:
    return os.path.join(BUILD_DIR, "libtext_analyzer.so")


def _build() -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logger.info("native build unavailable: no C++ compiler on PATH")
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path()}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path())
        return True
    except Exception as e:  # failed build → python path
        logger.info("native build unavailable: %s", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not os.path.exists(so) or (
                os.path.getmtime(_SRC) > os.path.getmtime(so)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            logger.info("native load failed: %s", e)
            return None
        lib.ta_analyze.restype = ctypes.c_int
        lib.ta_analyze.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
        lib.ti_create.restype = ctypes.c_void_p
        lib.ti_create.argtypes = []
        lib.ti_free.restype = None
        lib.ti_free.argtypes = [ctypes.c_void_p]
        lib.ti_push.restype = ctypes.c_int
        lib.ti_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_void_p, ctypes.c_int]
        lib.ti_analyze.restype = ctypes.c_longlong
        lib.ti_analyze.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ti_take.restype = None
        lib.ti_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode.restype = ctypes.c_int
        lib.wp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def is_ascii(text: str) -> bool:
    try:
        text.encode("ascii")
        return True
    except UnicodeEncodeError:
        return False


def _build_translit_table() -> dict[int, str]:
    """Semantics-preserving ASCII transliteration for the analyzer path.

    Maps characters whose ``analyze()`` outcome is identical after
    substitution: accented Latin letters → NFD base letter (the Python path
    strips accents the same way), Unicode punctuation → '.' (separate
    token, filtered either way), Unicode spaces → ' '.  Symbols (S*) and
    non-Latin scripts stay unmapped so those texts keep the Python path.
    """
    import unicodedata

    table: dict[int, str] = {}
    for cp in range(0x80, 0x2700):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        if cat == "Mn":
            table[cp] = ""
        elif cat.startswith(("P", "S")):
            table[cp] = "."
        elif cat.startswith("Z"):
            table[cp] = " "
        elif cat.startswith("L"):
            decomp = unicodedata.normalize("NFD", ch)
            base = "".join(c for c in decomp
                           if unicodedata.category(c) != "Mn")
            if base and is_ascii(base):
                table[cp] = base.lower()
    return table


_TRANSLIT = _build_translit_table()
# NUL and DEL: control characters the Python path drops; the C++ reads a
# NUL as the end of the text and keeps DEL as a letter, so both are
# removed before the call (the reference passes them through, and its two
# routes then disagree)
_DROPPED = {0x00: "", 0x7F: ""}
_TRANSLIT.update(_DROPPED)


def prepare_for_native(text: str) -> Optional[str]:
    """The text as the C++ analyzer may take it, or None when it holds
    characters only the Python path handles."""
    if is_ascii(text):
        if "\x00" in text or "\x7f" in text:
            text = text.translate(_DROPPED)
        return text
    text = text.translate(_TRANSLIT)
    return text if is_ascii(text) else None


def native_enabled() -> bool:
    """Whether the native route serves: on, and the library loads."""
    return _native_on and load_library() is not None


class NativeTermIds:
    """A table of term ids (term → id, dense from 0) in the native library,
    and the batched analysis that maps texts straight to ids.

    Its owner keeps it equal to its own table: terms it interns elsewhere
    (the Python route) are ``push``-ed in id order before the next
    ``analyze``.  Not safe for two threads at once."""

    def __init__(self):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.ti_create()
        self.size = 0

    def push(self, terms: Sequence[str]) -> None:
        """Append terms the table lacks, with the next ids."""
        if not terms:
            return
        raw = [t.encode("utf-8") for t in terms]
        lens = np.fromiter(map(len, raw), np.int32, len(raw))
        size = self._lib.ti_push(self._handle, b"".join(raw),
                                 lens.ctypes.data, len(raw))
        if size != self.size + len(raw):
            raise RuntimeError("native term table out of step with its owner")
        self.size = size

    def analyze(self, texts: Sequence[str], *, stemming: bool = False):
        """ASCII texts (``prepare_for_native``'s) → (ids int32 [T] of every
        text's terms in order, counts int32 [n] of terms a text, the terms
        new to the table in id order)."""
        counts = np.empty(len(texts), np.int32)
        if not texts:
            return np.empty(0, np.int32), counts, []
        blob = "\0".join(texts).encode("ascii")
        fresh_len = ctypes.c_longlong()
        n_ids = self._lib.ti_analyze(self._handle, blob, len(blob),
                                     len(texts), 1 if stemming else 0,
                                     counts.ctypes.data,
                                     ctypes.byref(fresh_len))
        ids = np.empty(n_ids, np.int32)
        fresh = np.empty(fresh_len.value, np.uint8)
        self._lib.ti_take(self._handle, ids.ctypes.data, fresh.ctypes.data)
        new = fresh.tobytes().decode("ascii").split("\x01") if len(fresh) \
            else []
        self.size += len(new)
        count_route("analyze:native_batch", len(texts))
        return ids, counts, new

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ti_free(handle)


def native_analyze(text: str, *, stemming: bool = False) -> Optional[list[str]]:
    """BM25 term analysis via C++; None → caller uses the Python path."""
    lib = load_library() if _native_on else None
    if lib is None:
        return None
    text = prepare_for_native(text)
    if text is None:
        return None
    raw = text.encode("ascii")
    cap = max(len(raw) * 2 + 16, 256)
    buf = ctypes.create_string_buffer(cap)
    n = lib.ta_analyze(raw, 1 if stemming else 0, buf, cap)
    if n < 0:
        return None
    if n == 0:
        return []
    return buf.value.decode("ascii").split("\x01")


class NativeWordPiece:
    """ctypes wrapper over the C++ WordPiece encoder."""

    def __init__(self, vocab: dict[str, int]):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # id = line index ⇒ emit tokens in id order
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [i for _t, i in ordered] != list(range(len(ordered))):
            raise ValueError("vocab ids must be dense 0..n-1")
        blob = "\n".join(t for t, _i in ordered).encode("utf-8")
        self._handle = lib.wp_create(blob)

    def encode(self, text: str, max_length: int, *, cls_id: int,
               sep_id: int, unk_id: int) -> Optional[list[int]]:
        if not _native_on or not is_ascii(text):
            return None
        if "\x00" in text or "\x7f" in text:
            text = text.translate(_DROPPED)
        cap = max_length + 8
        out = (ctypes.c_int * cap)()
        n = self._lib.wp_encode(
            self._handle, text.encode("ascii"), max_length, out, cap,
            cls_id, sep_id, unk_id,
        )
        if n < 0:
            return None
        return list(out[:n])

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_free(handle)
