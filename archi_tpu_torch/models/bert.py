"""BERT-class text encoder as a PyTorch module.

Counterpart of ``archi_tpu/models/bert.py``: post-LN BERT layers with exact
GELU and LayerNorm statistics in f32, ``mean`` / ``cls`` / ``attn`` pooling
and L2 normalisation.  Covers the MiniLM / bge-small / bge-base families.

- Linear weights are stored as ``nn.Linear`` weights, ``[out, in]`` (the
  HuggingFace orientation); ``hf_loader.params_from_jax`` transposes the
  JAX package's ``[in, out]`` matrices when it carries weights across.
- The q, k and v projections are one fused ``[3H, H]`` linear; the
  attention kernel reads its ``[B, S, 3H]`` output per head through strides.
- Embedding tables and LayerNorm parameters stay f32; the linear layers run
  in the compute dtype (bf16 on the card), as the JAX package casts its f32
  parameters to the compute dtype at use.  ``from_state`` stores the linear
  weights in that dtype for serving; ``for_training`` keeps every parameter
  f32 (the master copy the optimizer updates) and casts at use.
- ``embed`` is the differentiable forward pass; ``encode`` and
  ``encode_tokens`` run under ``torch.inference_mode``.  Attention is
  ``ops.attention.differentiable_attention``: the kernel's forward, and a
  gradient recomputed through the plain version under autograd.  The JAX
  package's ``attention_impl`` argument selects it: ``"kernel"`` (the
  default; the JAX ``"pallas"``) or ``"plain"`` (``plain_attention``, the
  JAX ``"xla"``), which runs only when a caller names it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from archi_tpu_torch.ops.attention import (differentiable_attention,
                                           plain_attention)

#: ``attention_impl`` → the attention a layer calls
ATTENTION = {"kernel": differentiable_attention, "plain": plain_attention}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # "mean" (MiniLM default), "cls" (bge), or "attn" (learned token gate)
    pooling: str = "mean"
    normalize: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls()

    @classmethod
    def bge_small(cls) -> "BertConfig":
        return cls(hidden_size=384, num_layers=12, num_heads=12,
                   intermediate_size=1536, pooling="cls")

    @classmethod
    def bge_base(cls) -> "BertConfig":
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   intermediate_size=3072, pooling="cls")


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """Deterministic random weights as the JAX package's parameter tree
    (numpy f32, ``[in, out]`` matrices, layers stacked): the same draws, in
    the same order, as ``archi_tpu.models.bert.init_params``.  Turn it into
    a module state with ``hf_loader.params_from_jax``."""
    rng = np.random.default_rng(seed)
    h, f, L = config.hidden_size, config.intermediate_size, config.num_layers

    def w(*shape, scale=0.02):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    params = {
        "embeddings": {
            "word": w(config.vocab_size, h),
            "position": w(config.max_position_embeddings, h),
            "token_type": w(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "q_w": w(L, h, h), "q_b": zeros(L, h),
            "k_w": w(L, h, h), "k_b": zeros(L, h),
            "v_w": w(L, h, h), "v_b": zeros(L, h),
            "o_w": w(L, h, h), "o_b": zeros(L, h),
            "attn_ln_scale": ones(L, h), "attn_ln_bias": zeros(L, h),
            "ffn_i_w": w(L, h, f), "ffn_i_b": zeros(L, f),
            "ffn_o_w": w(L, f, h), "ffn_o_b": zeros(L, h),
            "ffn_ln_scale": ones(L, h), "ffn_ln_bias": zeros(L, h),
        },
    }
    if config.pooling == "attn":
        # zero-init → uniform softmax → exactly mean pooling at step 0
        params["pool_attn"] = {"w": zeros(h)}
    return params


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in x's dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin(x)`` in x's dtype (the parameters cast at use when they are
    kept in another, as the JAX package does)."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class EncoderLayer(nn.Module):
    """One post-LN BERT layer."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        self.num_heads = config.num_heads
        self.qkv = nn.Linear(h, 3 * h)
        self.o = nn.Linear(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.ffn_i = nn.Linear(h, f)
        self.ffn_o = nn.Linear(f, h)
        self.ffn_ln = nn.LayerNorm(h, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor,
                attention_impl: str = "kernel") -> torch.Tensor:
        """x: [B, S, H]; key_bias: [B, S] f32 (0 real, -1e9 padding)."""
        b, s, h = x.shape
        nh = self.num_heads
        hd = h // nh
        qkv = _linear(x, self.qkv)                          # [B, S, 3H]
        q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd)
                   for i in range(3))
        ctx = ATTENTION[attention_impl](q, k, v, key_bias,
                                        sm_scale=1.0 / math.sqrt(hd))
        x = _layer_norm(x + _linear(ctx.view(b, s, h), self.o), self.attn_ln)
        inter = F.gelu(_linear(x, self.ffn_i).float(),
                       approximate="none").to(x.dtype)
        return _layer_norm(x + _linear(inter, self.ffn_o), self.ffn_ln)


class BertEncoder(nn.Module):
    """Embeddings + encoder layers → per-token hidden states."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word = nn.Embedding(config.vocab_size, h)
        self.position = nn.Embedding(config.max_position_embeddings, h)
        self.token_type = nn.Embedding(config.type_vocab_size, h)
        self.emb_ln = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(config) for _ in range(config.num_layers))
        if config.pooling == "attn":
            self.pool_attn = nn.Parameter(torch.zeros(h))
        #: dtype of the encoder layers' activations and products
        self.compute_dtype = torch.float32

    @classmethod
    def from_state(cls, config: BertConfig, state: dict, *, device,
                   compute_dtype=torch.float32) -> "BertEncoder":
        """A model holding ``state`` on ``device``, in eval mode, with its
        linear layers in ``compute_dtype``."""
        model = cls(config)
        model.load_state_dict(state)
        model.to(device)
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.to(compute_dtype)
        model.compute_dtype = compute_dtype
        return model.eval().requires_grad_(False)

    @classmethod
    def for_training(cls, config: BertConfig, state: dict, *, device,
                     compute_dtype=torch.float32) -> "BertEncoder":
        """A trainable model holding ``state`` on ``device``: every
        parameter f32 and requiring gradients, the forward pass in
        ``compute_dtype`` (the JAX trainer's f32 parameters under
        ``encode(..., compute_dtype=jnp.bfloat16)``)."""
        model = cls(config)
        model.load_state_dict(state)
        model.to(device)
        model.compute_dtype = compute_dtype
        return model.train().requires_grad_(True)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                attention_impl: str = "kernel"):
        """input_ids, attention_mask: [B, S] → [B, S, H] in compute dtype;
        ``attention_impl``: ``"kernel"`` or ``"plain"``."""
        if attention_impl not in ATTENTION:
            raise ValueError(f"attention_impl {attention_impl!r}: expected "
                             f"one of {sorted(ATTENTION)}")
        s = input_ids.shape[1]
        x = self.word(input_ids) + self.position.weight[:s][None, :, :]
        if token_type_ids is None:
            x = x + self.token_type.weight[0][None, None, :]
        else:
            x = x + self.token_type(token_type_ids)
        x = _layer_norm(x, self.emb_ln).to(self.compute_dtype)
        key_bias = (1.0 - attention_mask.float()) * -1e9
        for layer in self.layers:
            x = layer(x, key_bias, attention_impl)
        return x


def embed(model: BertEncoder, input_ids, attention_mask,
          token_type_ids=None, attention_impl: str = "kernel") -> torch.Tensor:
    """Forward pass → pooled, (optionally) L2-normalized [B, H] f32, under
    autograd when it is on (the trainer's loss)."""
    config = model.config
    x = model(input_ids, attention_mask, token_type_ids,
              attention_impl).float()
    m = attention_mask.float()[:, :, None]
    if config.pooling == "cls":
        pooled = x[:, 0, :]
    elif config.pooling == "attn":
        scores = torch.einsum("bsh,h->bs", x, model.pool_attn.float())
        scores = scores + (1.0 - m[:, :, 0]) * -1e9
        alpha = torch.softmax(scores, dim=-1)
        pooled = torch.einsum("bs,bsh->bh", alpha, x)
    else:  # mean pooling over non-pad tokens
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    if config.normalize:
        pooled = pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


@torch.inference_mode()
def encode(model: BertEncoder, input_ids, attention_mask,
           token_type_ids=None, *, attention_impl: str = "kernel"
           ) -> torch.Tensor:
    """Forward pass → pooled, (optionally) L2-normalized [B, H] f32."""
    return embed(model, input_ids, attention_mask, token_type_ids,
                 attention_impl)


@torch.inference_mode()
def encode_tokens(model: BertEncoder, input_ids, attention_mask,
                  token_type_ids=None, *, attention_impl: str = "kernel"
                  ) -> torch.Tensor:
    """Forward pass → per-token hidden states [B, S, H] f32 (no pooling)."""
    return model(input_ids, attention_mask, token_type_ids,
                 attention_impl).float()
