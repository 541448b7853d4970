"""Plain reference of a post-LN BERT encoder (MiniLM, bge), in float32.

Written from the BERT paper's layer equations as the sentence-transformers
checkpoints use them: word + position + token-type embeddings and a
LayerNorm, then per layer softmax(QK^T / sqrt(d) + mask) V, an output
projection, a residual LayerNorm, an exact-GELU feed-forward and a second
residual LayerNorm; mean or [CLS] pooling; L2 normalisation.  Weights are
the dict that ``ragbench/weights.py`` makes (keys
``layers.<i>.qkv.weight`` etc., matrices ``[out, in]``).

``precision="fp8"`` is the control: every linear layer's input and weight
rounded to float8 e4m3 with a per-tensor scale (amax / 448) before the
float32 product, as an fp8 inference path would compute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_float32() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale for the tensor, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x, w, b, fp8: bool):
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    return x @ w.t() + b


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def encode(weights: dict, ids: torch.Tensor, mask: torch.Tensor, *,
           num_layers: int, num_heads: int, pooling: str,
           eps: float = 1e-12, precision: str = "float32") -> torch.Tensor:
    """ids, mask: [B, S] → [B, H] unit vectors, float32; ``weights`` in
    float32 on the device of ``ids``."""
    fp8 = precision == "fp8"
    w = weights
    b, s = ids.shape
    x = w["word"][ids] + w["position"][:s][None] + w["token_type"][0]
    x = _ln(x, w["emb_ln.weight"], w["emb_ln.bias"], eps)
    h = x.shape[-1]
    hd = h // num_heads
    key_bias = (1.0 - mask.float())[:, None, None, :] * -1e9
    for i in range(num_layers):
        p = f"layers.{i}."
        qkv = _linear(x, w[p + "qkv.weight"], w[p + "qkv.bias"], fp8)
        q, k, v = (qkv[..., j * h:(j + 1) * h].reshape(b, s, num_heads, hd)
                   .transpose(1, 2) for j in range(3))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd)
                            + key_bias, dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(b, s, h)
        x = _ln(x + _linear(ctx, w[p + "o.weight"], w[p + "o.bias"], fp8),
                w[p + "attn_ln.weight"], w[p + "attn_ln.bias"], eps)
        inter = F.gelu(_linear(x, w[p + "ffn_i.weight"], w[p + "ffn_i.bias"],
                               fp8))
        x = _ln(x + _linear(inter, w[p + "ffn_o.weight"],
                            w[p + "ffn_o.bias"], fp8),
                w[p + "ffn_ln.weight"], w[p + "ffn_ln.bias"], eps)
    m = mask.float()[:, :, None]
    if pooling == "cls":
        pooled = x[:, 0]
    else:
        pooled = (x * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return F.normalize(pooled, dim=-1)


def encode_texts(weights: dict, token_lists: list[list[int]], *, device,
                 num_layers: int, num_heads: int, pooling: str,
                 precision: str = "float32", block: int = 64
                 ) -> torch.Tensor:
    """Token-id lists → [n, H] float32, in blocks of sequences padded to
    the block's longest (padding is masked out)."""
    weights = {k: v.to(device, torch.float32) for k, v in weights.items()}
    outs = []
    for s0 in range(0, len(token_lists), block):
        part = token_lists[s0:s0 + block]
        s = max(len(t) for t in part)
        ids = torch.zeros((len(part), s), dtype=torch.long)
        mask = torch.zeros((len(part), s), dtype=torch.long)
        for r, t in enumerate(part):
            ids[r, :len(t)] = torch.tensor(t)
            mask[r, :len(t)] = 1
        outs.append(encode(weights, ids.to(device), mask.to(device),
                           num_layers=num_layers, num_heads=num_heads,
                           pooling=pooling, precision=precision))
    return torch.cat(outs)
