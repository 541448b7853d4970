"""Encoder self-attention: the CUDA kernel and its plain PyTorch version.

Counterpart of ``archi_tpu/ops/pallas_attention.py`` (``encoder_attention``).
Both compute ``softmax(q kᵀ · sm_scale + key_bias) v`` per (batch, head)
with an exact full-row softmax in the exp2 domain, f32 accumulation and the
normalisation applied last.  The layout is ``[B, S, nh, hd]`` — the
encoder's projection output viewed per head — instead of the TPU kernel's
``[B, nh, hd, S]``; q, k and v may be strided views of one fused
``[B, S, 3H]`` projection.  ``encoder_attention`` launches
``csrc/encoder_attention.cu`` on CUDA tensors and takes
``plain_attention`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from archi_tpu_torch.ops import LAUNCHES, _build

LOG2E = 1.4426950408889634
#: head dims the kernel is compiled for
HEAD_DIMS = (8, 16, 32, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def plain_attention(q, k, v, key_bias, *, sm_scale: float):
    """Plain PyTorch attention with the kernel's arithmetic.

    q, k, v: [B, S, nh, hd]; key_bias: [B, S] f32 (0 real, -1e9 padding).
    Returns the contiguous context [B, S, nh, hd] in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = key_bias.float() * LOG2E
    logits = (torch.einsum("bqnd,bknd->bnqk", qf, kf) * (sm_scale * LOG2E)
              + bias[:, None, None, :])
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    denom = p.sum(dim=-1)                                   # [B, nh, S]
    ctx = torch.einsum("bnqk,bknd->bqnd", p, vf)
    ctx = ctx * (1.0 / denom).permute(0, 2, 1)[..., None]
    return ctx.to(q.dtype).contiguous()


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("encoder_attention")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.archi_encoder_attention.restype = i
        lib.archi_encoder_attention.argtypes = [
            i, vp, vp, vp, i, vp, vp, i, i, i, i, f, vp]
        lib.archi_attention_error_string.restype = ctypes.c_char_p
        lib.archi_attention_error_string.argtypes = [i]
        _lib = lib
    return _lib


def encoder_attention(q, k, v, key_bias, *, sm_scale: float):
    """Bidirectional attention with a key-side additive bias.

    Args:
      q, k, v: [B, S, nh, hd] bf16 or f32, one dtype; the last dim dense
        and the same strides for all three (views of one projection).
      key_bias: [B, S] f32 additive bias on keys (0 real, -1e9 padding).
      sm_scale: logit scale (``1/sqrt(hd)``).
    Returns:
      [B, S, nh, hd] contiguous context in q's dtype.  CPU tensors take
      ``plain_attention``.
    """
    if q.device.type == "cpu":
        return plain_attention(q, k, v, key_bias, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"encoder_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of float32/bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, nh, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"encoder_attention: head dim {hd} not in {HEAD_DIMS}")
    if b > 65535:
        raise ValueError(f"encoder_attention: batch {b} > 65535")
    row = q.stride(1)
    want = (s * row, row, hd, 1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride() != want or t.device != q.device:
            raise ValueError(
                f"encoder_attention: {name} strides {t.stride()} on "
                f"{t.device}, expected {want} on {q.device}")
    if key_bias.shape != (b, s) or key_bias.device != q.device:
        raise ValueError(f"encoder_attention: key_bias {tuple(key_bias.shape)} "
                         f"on {key_bias.device}, expected ({b}, {s})")
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = lib.archi_encoder_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            row, key_bias.data_ptr(), out.data_ptr(), b, s, nh, hd,
            sm_scale * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"encoder_attention launch: "
            f"{lib.archi_attention_error_string(rc).decode()} (error {rc})")
    LAUNCHES["encoder_attention"] += 1
    return out
