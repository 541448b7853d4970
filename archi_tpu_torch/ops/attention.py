"""Encoder self-attention: the CUDA kernel and its plain PyTorch version.

Counterpart of ``archi_tpu/ops/pallas_attention.py`` (``encoder_attention``).
Both compute ``softmax(q kᵀ · sm_scale + key_bias) v`` per (batch, head)
with an exact full-row softmax in the exp2 domain, f32 accumulation and the
normalisation applied last.  The layout is ``[B, S, nh, hd]`` — the
encoder's projection output viewed per head — instead of the TPU kernel's
``[B, nh, hd, S]``; q, k and v may be strided views of one fused
``[B, S, 3H]`` projection.  As in the TPU kernel, the unnormalised
probabilities are rounded to the input type before the PV product (a no-op
in f32) and the row sum is taken from them in f32.  ``encoder_attention``
launches ``csrc/encoder_attention.cu`` on CUDA tensors — bf16 on the
tensor cores, f32 on the CUDA cores — and takes ``plain_attention`` on CPU
tensors.

``differentiable_attention`` is the same call under autograd, for training:
its forward is ``encoder_attention`` (the kernel on the card), its backward
recomputes the gradient through ``plain_attention`` from the saved q, k, v
and key bias.  The TPU kernel has no backward either: the JAX trainer runs
XLA attention under ``jax.grad``.
"""

from __future__ import annotations

import ctypes

import torch

from archi_tpu_torch.ops import _build, count_launch

LOG2E = 1.4426950408889634
#: head dims the kernel is compiled for
HEAD_DIMS = (8, 16, 32, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "tensor_core"}


def _wide(t):
    """f32, or f64 for f64 inputs (gradient checks in double precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _probabilities(q, k, key_bias, sm_scale):
    """Unnormalised f32 probabilities [B, nh, S, S] and their row sums."""
    bias = _wide(key_bias) * LOG2E
    logits = (torch.einsum("bqnd,bknd->bnqk", _wide(q), _wide(k))
              * (sm_scale * LOG2E) + bias[:, None, None, :])
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1)


def _normalise(ctx, denom):
    return ctx * (1.0 / denom).permute(0, 2, 1)[..., None]


def plain_attention(q, k, v, key_bias, *, sm_scale: float):
    """Plain PyTorch attention with the kernel's arithmetic.

    q, k, v: [B, S, nh, hd]; key_bias: [B, S] f32 (0 real, -1e9 padding).
    Returns the contiguous context [B, S, nh, hd] in q's dtype."""
    p, denom = _probabilities(q, k, key_bias, sm_scale)
    p = _wide(p.to(q.dtype))        # the TPU kernel's p.astype(v.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", p, _wide(v))
    return _normalise(ctx, denom).to(q.dtype).contiguous()


def p_rounding_bound(q, k, v, key_bias, *, sm_scale: float):
    """[B, S, nh, hd] f32: how far two versions that round p to bf16 may
    differ through that rounding alone, one bf16 step of each probability
    (at most 2^-7 p): ``2^-7 · Σ_j p_j |v_j| / l``.  The kernel and the plain
    version sum the logits in another order, so a p that lies next to a
    bf16 rounding boundary may round up in one and down in the other."""
    p, denom = _probabilities(q, k, key_bias, sm_scale)
    ctx = torch.einsum("bnqk,bknd->bqnd", p, v.float().abs())
    return _normalise(ctx, denom) * 2.0 ** -7


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("encoder_attention")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.archi_encoder_attention.restype = i
        lib.archi_encoder_attention.argtypes = [
            i, vp, vp, vp, i, vp, vp, i, i, i, i, f, i, vp]
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
    row = q.stride(1) if s > 1 else q.stride(0)
    want = (s * row, row, hd, 1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        # a dimension of size 1 may carry any stride
        if t.device != q.device or any(
                st != w and n > 1 for st, w, n in zip(t.stride(), want, t.shape)):
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
    # 16-byte copies of K and V rows need aligned views and row strides
    vec = int(row % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    with torch.cuda.device(q.device):
        rc = lib.archi_encoder_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            row, key_bias.data_ptr(), out.data_ptr(), b, s, nh, hd,
            sm_scale * LOG2E, vec,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"encoder_attention launch: "
            f"{lib.archi_attention_error_string(rc).decode()} (error {rc})")
    count_launch("encoder_attention", _ROUTES[q.dtype])
    return out


class _EncoderAttention(torch.autograd.Function):
    """``encoder_attention`` forward; gradient of ``plain_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        ctx.save_for_backward(q, k, v, key_bias)
        ctx.sm_scale = sm_scale
        return encoder_attention(q, k, v, key_bias, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = plain_attention(*inputs, sm_scale=ctx.sm_scale)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if n else None for n in needs), None)


def differentiable_attention(q, k, v, key_bias, *, sm_scale: float):
    """``encoder_attention`` with a gradient (module docstring); outside
    autograd (``torch.no_grad``, ``torch.inference_mode``) it is
    ``encoder_attention`` itself."""
    if not torch.is_grad_enabled():
        return encoder_attention(q, k, v, key_bias, sm_scale=sm_scale)
    return _EncoderAttention.apply(q, k, v, key_bias, sm_scale)
