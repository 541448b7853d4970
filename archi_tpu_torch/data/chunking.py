"""Text chunking for ingest.

Copy of ``archi_tpu/data/chunking.py``.

Two splitters matching the reference's behavior:
- ``character_split``: the CharacterTextSplitter semantics the reference
  uses at ingest (``src/data_manager/vectorstore/manager.py:75-78``, default
  chunk_size 1000 / overlap 0 per ``base-config.yaml:153-154``): split on a
  separator, greedily merge pieces up to chunk_size, overlap by trailing
  pieces.
- ``sliding_window_split``: the legacy fixed-window chunker
  (``collectors/utils/embedding_utils.py:7``).
"""

from __future__ import annotations


def character_split(
    text: str,
    chunk_size: int = 1000,
    chunk_overlap: int = 0,
    separator: str = "\n\n",
) -> list[str]:
    if not text:
        return []
    pieces = text.split(separator) if separator else list(text)
    sep_len = len(separator)

    # split any oversized piece hard
    norm: list[str] = []
    for p in pieces:
        while len(p) > chunk_size:
            norm.append(p[:chunk_size])
            p = p[chunk_size:]
        norm.append(p)

    chunks: list[str] = []
    cur: list[str] = []
    cur_len = 0
    for p in norm:
        add = len(p) + (sep_len if cur else 0)
        if cur and cur_len + add > chunk_size:
            chunks.append(separator.join(cur))
            # retain overlap from the tail
            if chunk_overlap > 0:
                kept: list[str] = []
                kept_len = 0
                for q in reversed(cur):
                    q_add = len(q) + (sep_len if kept else 0)
                    if kept_len + q_add > chunk_overlap:
                        break
                    kept.insert(0, q)
                    kept_len += q_add
                cur, cur_len = kept, kept_len
            else:
                cur, cur_len = [], 0
        cur.append(p)
        cur_len += len(p) + (sep_len if len(cur) > 1 else 0)
    if cur:
        chunks.append(separator.join(cur))
    return [c for c in (c.strip() for c in chunks) if c]


def sliding_window_split(
    text: str, window: int = 1000, stride: int = 800
) -> list[str]:
    if not text:
        return []
    out = []
    for start in range(0, max(len(text) - window, 0) + 1, stride):
        out.append(text[start: start + window])
        if start + window >= len(text):
            break
    if not out:
        out = [text]
    return out
