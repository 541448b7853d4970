"""Load BERT-family weights into ``BertEncoder`` states.

Counterpart of ``archi_tpu/models/hf_loader.py``.  A *local* HuggingFace
snapshot directory (``config.json`` + ``vocab.txt`` + ``model.safetensors``
or ``pytorch_model.bin``) loads as it is — HF linear weights are already
``[out, in]``.  Without one, deterministic random weights are drawn
(``bert.init_params``).  ``params_from_jax`` carries the JAX package's
parameter tree (as numpy arrays) across, transposing its ``[in, out]``
matrices.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from archi_tpu_torch.models.bert import BertConfig, init_params

_LAYER_KEYS = (
    "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
    "attn_ln_scale", "attn_ln_bias", "ffn_i_w", "ffn_i_b",
    "ffn_o_w", "ffn_o_b", "ffn_ln_scale", "ffn_ln_bias",
)


def config_from_hf(cfg: dict, *, pooling: str = "mean") -> BertConfig:
    # snapshots trained by the JAX package record their pooling mode in a
    # custom key; plain HF checkpoints fall back to the caller's choice
    pooling = cfg.get("archi_pooling", pooling)
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pooling=pooling,
    )


def _state(emb: dict, layers: list[dict], pool_attn=None) -> dict:
    """Module state from per-layer dicts of [out, in] weights (numpy)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {
        "word.weight": t(emb["word"]),
        "position.weight": t(emb["position"]),
        "token_type.weight": t(emb["token_type"]),
        "emb_ln.weight": t(emb["ln_scale"]),
        "emb_ln.bias": t(emb["ln_bias"]),
    }
    for i, lp in enumerate(layers):
        p = f"layers.{i}."
        sd[p + "qkv.weight"] = t(np.concatenate(
            [lp["q_w"], lp["k_w"], lp["v_w"]], axis=0))
        sd[p + "qkv.bias"] = t(np.concatenate([lp["q_b"], lp["k_b"], lp["v_b"]]))
        for name in ("o", "ffn_i", "ffn_o"):
            sd[p + f"{name}.weight"] = t(lp[f"{name}_w"])
            sd[p + f"{name}.bias"] = t(lp[f"{name}_b"])
        for name in ("attn_ln", "ffn_ln"):
            sd[p + f"{name}.weight"] = t(lp[f"{name}_scale"])
            sd[p + f"{name}.bias"] = t(lp[f"{name}_bias"])
    if pool_attn is not None:
        sd["pool_attn"] = t(pool_attn)
    return sd


def params_from_jax(tree: dict) -> dict:
    """The JAX package's parameter tree (``archi_tpu.models.bert``
    ``init_params`` layout, numpy arrays) → ``BertEncoder`` state.  Its
    ``[in, out]`` matrices are transposed to ``[out, in]``."""
    layers = tree["layers"]
    n_layers = np.asarray(layers["q_w"]).shape[0]
    per_layer = []
    for i in range(n_layers):
        lp = {k: np.asarray(layers[k][i]) for k in _LAYER_KEYS}
        for k in ("q_w", "k_w", "v_w", "o_w", "ffn_i_w", "ffn_o_w"):
            lp[k] = lp[k].T
        per_layer.append(lp)
    emb = {k: np.asarray(v) for k, v in tree["embeddings"].items()}
    pool = tree.get("pool_attn")
    return _state(emb, per_layer,
                  None if pool is None else np.asarray(pool["w"]))


def params_from_state_dict(sd: dict, config: BertConfig) -> dict:
    """A HF ``BertModel`` state dict (numpy or torch values) →
    ``BertEncoder`` state; no transpose."""
    def g(key):
        for prefix in ("", "bert.", "model."):
            if prefix + key in sd:
                v = sd[prefix + key]
                return (v.float().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v, np.float32))
        raise KeyError(key)

    emb = {
        "word": g("embeddings.word_embeddings.weight"),
        "position": g("embeddings.position_embeddings.weight"),
        "token_type": g("embeddings.token_type_embeddings.weight"),
        "ln_scale": g("embeddings.LayerNorm.weight"),
        "ln_bias": g("embeddings.LayerNorm.bias"),
    }
    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}."
        lp = {}
        for short, hf in (("q", "attention.self.query"),
                          ("k", "attention.self.key"),
                          ("v", "attention.self.value"),
                          ("o", "attention.output.dense"),
                          ("ffn_i", "intermediate.dense"),
                          ("ffn_o", "output.dense")):
            lp[f"{short}_w"] = g(p + hf + ".weight")
            lp[f"{short}_b"] = g(p + hf + ".bias")
        for short, hf in (("attn_ln", "attention.output.LayerNorm"),
                          ("ffn_ln", "output.LayerNorm")):
            lp[f"{short}_scale"] = g(p + hf + ".weight")
            lp[f"{short}_bias"] = g(p + hf + ".bias")
        layers.append(lp)
    pool = g("pooler_attn.weight") if config.pooling == "attn" else None
    return _state(emb, layers, pool)


def _read_state_dict(model_dir: str) -> dict:
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights in {model_dir}")


def load_model_dir(model_dir: str, *, pooling: str = "mean"):
    """Load (config, state, vocab_path) from a local HF snapshot dir."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    config = config_from_hf(hf_cfg, pooling=pooling)
    state = params_from_state_dict(_read_state_dict(model_dir), config)
    vocab = os.path.join(model_dir, "vocab.txt")
    return config, state, (vocab if os.path.exists(vocab) else None)


def load_or_init(model_dir: str | None, config: BertConfig | None = None,
                 *, pooling: str = "mean", seed: int = 0):
    """Checkpoint if available, else deterministic random weights."""
    if model_dir and os.path.isdir(model_dir):
        return load_model_dir(model_dir, pooling=pooling)
    config = config or BertConfig.minilm_l6()
    return config, params_from_jax(init_params(config, seed=seed)), None
