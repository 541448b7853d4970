"""Fused score + top-k scan: the CUDA kernel and its plain PyTorch version.

Counterpart of ``archi_tpu/ops/pallas_topk.py`` (``fused_topk``).  Both
functions return the top-k of ``q · E[i] + bias[i]`` over a padded corpus,
rows ``>= n_active`` scored ``NEG_INF``, equal scores ranked by the lower
row.  ``fused_topk`` launches ``csrc/fused_topk.cu`` on CUDA tensors —
bf16 and int8 corpora on the tensor cores, f32 on the CUDA cores — and
takes ``plain_topk`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from archi_tpu_torch.ops import _build, count_launch

NEG_INF = -1.0e30
#: largest k the kernel keeps (the TPU kernel's 128-lane running buffer)
MAX_K = 128
#: int8 dot products are summed exactly in f32 while D * 127^2 < 2^24
MAX_INT8_DIM = 1040

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: f32 corpora are scored on the CUDA cores, bf16 and int8 on the tensor cores
_ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "tensor_core",
           torch.int8: "tensor_core"}


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 of unit-norm vectors: ``clip(round(127 x))``."""
    return torch.clamp(torch.round(x.float() * 127.0), -127, 127).to(torch.int8)


def _scores(queries, corpus):
    """[B, n_pad] f32 products, computed as the kernel computes them: the
    query cast to the corpus type, bf16 operands upcast after their
    rounding, int8 summed as exact integers in f32 and scaled by 1/127²."""
    if corpus.dtype == torch.int8:
        q8 = quantize_int8(queries)
        return (q8.float() @ corpus.float().T) * (1.0 / (127.0 * 127.0))
    return queries.to(corpus.dtype).float() @ corpus.float().T


def plain_topk(queries, corpus, bias, n_active, *, k: int = 10):
    """Plain PyTorch top-k of ``q · E[i] + bias[i]`` (the counterpart of the
    JAX package's ``xla_topk``): materialises [B, n_pad] scores, ranks them
    with a stable sort so ties keep the lower row.

    Returns (vals [B, k] f32, idx [B, k] int32)."""
    n_pad = corpus.shape[0]
    scores = _scores(queries, corpus) + bias.float()
    col = torch.arange(n_pad, device=corpus.device)
    scores = torch.where(col < int(n_active), scores,
                         torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_topk")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.archi_fused_topk_plan.restype = i
        lib.archi_fused_topk_plan.argtypes = [
            i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.archi_fused_topk.restype = i
        lib.archi_fused_topk.argtypes = [
            i, vp, vp, vp, i, i, i, i, i, i, f, i, i, i, vp, vp, vp, vp, vp]
        lib.archi_topk_error_string.restype = ctypes.c_char_p
        lib.archi_topk_error_string.argtypes = [i]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: {lib.archi_topk_error_string(rc).decode()} (error {rc})")


def fused_topk(queries, corpus, bias, n_active, *, k: int = 10):
    """Top-k (k <= 128) of ``q · E[i] + bias[i]`` without a [B, n_pad]
    score matrix in device memory.

    Args:
      queries: [B, D] float; cast to the corpus type (int8: clip(round(127q))).
      corpus: [n_pad, D] float32, bfloat16 or int8 (rows = round(127 x)).
      bias: [n_pad] shared or [B, n_pad] per-query f32 additive bias.
      n_active: rows >= n_active score NEG_INF.
    Returns:
      (vals [B, k] f32, idx [B, k] int32).  CPU tensors take ``plain_topk``.
    """
    if corpus.device.type == "cpu":
        return plain_topk(queries, corpus, bias, n_active, k=k)
    if corpus.device.type != "cuda":
        raise ValueError(f"fused_topk: unsupported device {corpus.device}")
    if corpus.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_topk: unsupported corpus dtype {corpus.dtype}")
    if queries.dim() != 2 or corpus.dim() != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"fused_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(corpus.shape)}")
    b, d = queries.shape
    n_pad = corpus.shape[0]
    if not 1 <= k <= min(MAX_K, n_pad):
        raise ValueError(f"fused_topk: k={k} outside [1, min({MAX_K}, {n_pad})]")
    if bias.shape not in ((n_pad,), (b, n_pad)):
        raise ValueError(f"fused_topk: bias shape {tuple(bias.shape)}, "
                         f"expected ({n_pad},) or ({b}, {n_pad})")
    if corpus.dtype == torch.int8 and d > MAX_INT8_DIM:
        raise ValueError(f"fused_topk: int8 corpus needs D <= {MAX_INT8_DIM}")
    for name, t in (("queries", queries), ("bias", bias)):
        if t.device != corpus.device:
            raise ValueError(f"fused_topk: {name} on {t.device}, "
                             f"corpus on {corpus.device}")
    if not corpus.is_contiguous():
        raise ValueError("fused_topk: corpus must be contiguous")
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=corpus.device),
                torch.empty((0, k), dtype=torch.int32, device=corpus.device))
    q = (quantize_int8(queries) if corpus.dtype == torch.int8
         else queries.to(corpus.dtype)).contiguous()
    bias = bias.to(torch.float32).contiguous()
    n_active = max(0, min(int(n_active), n_pad))
    lib = _kernel()
    code = _DTYPE_CODES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        splits, rows_per_split = ctypes.c_int(), ctypes.c_int()
        _check(lib, lib.archi_fused_topk_plan(
            code, b, d, n_active, k, int(bias.dim() == 2), ctypes.byref(splits),
            ctypes.byref(rows_per_split)), "fused_topk plan")
        dev = corpus.device
        part_v = torch.empty((b, splits.value, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, splits.value, k), dtype=torch.int32, device=dev)
        out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        # 16-byte row loads need aligned rows: f32 in whole 32-element
        # chunks, bf16 and int8 in whole 16-byte pieces
        step = 32 if corpus.dtype == torch.float32 else 16 // corpus.element_size()
        vec = int(d % step == 0 and corpus.data_ptr() % 16 == 0)
        scale = 1.0 / (127.0 * 127.0) if corpus.dtype == torch.int8 else 1.0
        _check(lib, lib.archi_fused_topk(
            code, q.data_ptr(), corpus.data_ptr(), bias.data_ptr(),
            int(bias.dim() == 2), b, d, n_pad, n_active, k, scale,
            splits.value, rows_per_split.value, vec,
            part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "fused_topk launch")
    count_launch("fused_topk", _ROUTES[corpus.dtype])
    return out_v, out_i
