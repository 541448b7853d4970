"""BM25 scatter of a batch of queries: the CUDA kernel and its plain
PyTorch version.

Counterpart of the scatter in ``archi_tpu/engine/bm25.py``
(``_scatter_scores``).  A work list of postings pieces, one row each of an
int32 ``[W, 4]`` tensor (query, start, length, the bits of the term's f32
idf), scores the pieces' postings entries into dense rows::

    denom = tf + k1 * ((1 - b) + b * dl * inv_avgdl)
    out[q, row] += idf * tf * (k1 + 1) / max(denom, 1e-9)

for ``row < n_pad`` (rows past it are dropped), and sets ``hit[q]`` where
some entry of query q landed.  ``bm25_scatter`` launches
``csrc/bm25_scatter.cu`` on CUDA tensors and takes ``plain_bm25_scatter``
on CPU tensors.  Both return ``(scores [n_rows, n_pad] f32, hit [n_rows]
bool)``: one zeroed allocation holds both, so the rows past the work list's
queries (a batch padded to a power of two) come out zero.
"""

from __future__ import annotations

import ctypes

import torch

from archi_tpu_torch.ops import _build, count_launch

#: the columns of a work-list row
QUERY, START, LENGTH, IDF = range(4)


def _outputs(n_rows: int, n_pad: int, device):
    """(scores [n_rows, n_pad] f32, hit [n_rows] bool), zero, from one
    allocation: the flags sit in the f32 words after the scores."""
    flat = torch.zeros(n_rows * n_pad + (n_rows + 3) // 4,
                       dtype=torch.float32, device=device)
    scores = flat[:n_rows * n_pad].view(n_rows, n_pad)
    hit = flat[n_rows * n_pad:].view(torch.uint8)[:n_rows].view(torch.bool)
    return scores, hit


def plain_bm25_scatter(rows_buf, tf_buf, dl_buf, work, inv_avgdl: float, *,
                       n_pad: int, n_rows: int, k1: float, b: float):
    """Plain version of ``bm25_scatter``: gathers every entry of the work
    list's pieces, computes the impacts in the kernel's order and adds them
    with one ``index_add_``."""
    scores, hit = _outputs(n_rows, n_pad, rows_buf.device)
    if work.shape[0] == 0:
        return scores, hit
    dev = rows_buf.device
    lens = work[:, LENGTH].long()
    total = int(lens.sum())
    piece = torch.repeat_interleave(
        torch.arange(work.shape[0], device=dev), lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens           # output offset of each
    pos = work[:, START].long()[piece] + torch.arange(total, device=dev) \
        - first[piece]
    tf = tf_buf[pos]
    dl = dl_buf[pos]
    denom = tf + k1 * (1.0 - b + b * dl * inv_avgdl)
    idf = work[:, IDF].view(torch.float32)[piece]
    imps = idf * tf * (k1 + 1.0) / torch.clamp(denom, min=1e-9)
    rows = rows_buf[pos].long()
    keep = (rows >= 0) & (rows < n_pad)
    query = work[:, QUERY].long()[piece][keep]
    scores.view(-1).index_add_(0, query * n_pad + rows[keep], imps[keep])
    hit[query] = True
    return scores, hit


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("bm25_scatter")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.archi_bm25_scatter.restype = i
        lib.archi_bm25_scatter.argtypes = [
            vp, i, vp, vp, vp, vp, vp, ctypes.c_longlong, f, f, f, f, f, vp]
        lib.archi_bm25_error_string.restype = ctypes.c_char_p
        lib.archi_bm25_error_string.argtypes = [i]
        _lib = lib
    return _lib


def bm25_scatter(rows_buf, tf_buf, dl_buf, work, inv_avgdl: float, *,
                 n_pad: int, n_rows: int, k1: float, b: float):
    """BM25 impacts of the work list's pieces, scattered into dense rows.

    Args:
      rows_buf, tf_buf, dl_buf: postings buffers [cap] int32, f32, f32.
      work: [W, 4] int32 on the buffers' device (query < n_rows, start,
        length, idf bits); pieces lie inside the buffers.
      inv_avgdl: 1 / the mean document length.
    Returns:
      (scores [n_rows, n_pad] f32, hit [n_rows] bool).  CPU tensors take
      ``plain_bm25_scatter``; on CUDA one zero fill and one launch.
    """
    dev = rows_buf.device
    if dev.type == "cpu":
        return plain_bm25_scatter(rows_buf, tf_buf, dl_buf, work, inv_avgdl,
                                  n_pad=n_pad, n_rows=n_rows, k1=k1, b=b)
    if dev.type != "cuda":
        raise ValueError(f"bm25_scatter: unsupported device {dev}")
    for name, t, dtype in (("rows_buf", rows_buf, torch.int32),
                           ("tf_buf", tf_buf, torch.float32),
                           ("dl_buf", dl_buf, torch.float32),
                           ("work", work, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"bm25_scatter: {name} must be contiguous "
                             f"{dtype} on {dev}, got {t.dtype} on {t.device}")
    if work.dim() != 2 or work.shape[1] != 4 or work.data_ptr() % 16:
        raise ValueError(f"bm25_scatter: work shape {tuple(work.shape)} at "
                         f"{work.data_ptr():#x}, expected (W, 4), 16-byte "
                         f"aligned")
    scores, hit = _outputs(n_rows, n_pad, dev)
    if work.shape[0] == 0:
        return scores, hit
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.archi_bm25_scatter(
            work.data_ptr(), work.shape[0], rows_buf.data_ptr(),
            tf_buf.data_ptr(), dl_buf.data_ptr(), scores.data_ptr(),
            hit.data_ptr(), n_pad, k1, 1.0 - b, b, k1 + 1.0, inv_avgdl,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bm25_scatter launch: "
                           f"{lib.archi_bm25_error_string(rc).decode()} "
                           f"(error {rc})")
    count_launch("bm25_scatter")
    return scores, hit
