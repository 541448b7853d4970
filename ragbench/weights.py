"""Encoder weights and index rows made on the device from the seed.

The weights are one dict in the BERT layout of ``reference/bert.py``:
linear layers ``[out, in]`` with their biases in bfloat16 (the type the
encoder serves them in), embeddings and LayerNorms in float32.  They are
drawn in two calls, one per type, and sliced.  Both sides get the same
dict: the deployment hands it to the program, the check to the reference.
"""

from __future__ import annotations

import torch

from ragbench.textgen import rng_for


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng_for(seed, stream).integers(0, 2 ** 63 - 1)))
    return g


def _shapes(enc: dict) -> tuple[list, list]:
    h, f = enc["hidden_size"], enc["intermediate_size"]
    lin, flt = [], [("word", (enc["vocab_size"], h)),
                    ("position", (enc["max_position_embeddings"], h)),
                    ("token_type", (enc["type_vocab_size"], h)),
                    ("emb_ln.weight", (h,)), ("emb_ln.bias", (h,))]
    for i in range(enc["num_hidden_layers"]):
        p = f"layers.{i}."
        lin += [(p + "qkv.weight", (3 * h, h)), (p + "qkv.bias", (3 * h,)),
                (p + "o.weight", (h, h)), (p + "o.bias", (h,)),
                (p + "ffn_i.weight", (f, h)), (p + "ffn_i.bias", (f,)),
                (p + "ffn_o.weight", (h, f)), (p + "ffn_o.bias", (h,))]
        flt += [(p + "attn_ln.weight", (h,)), (p + "attn_ln.bias", (h,)),
                (p + "ffn_ln.weight", (h,)), (p + "ffn_ln.bias", (h,))]
    return lin, flt


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def encoder_weights(enc: dict, seed: int, device) -> dict:
    """Random BERT weights: N(0, 0.02) matrices, embeddings and biases;
    LayerNorm scales 1 + N(0, 0.1), shifts N(0, 0.02)."""
    g = generator(seed, "weights", device)
    out = {}
    for dtype, specs in zip((torch.bfloat16, torch.float32), _shapes(enc)):
        total = sum(_numel(s) for _, s in specs)
        flat = torch.randn(total, generator=g, device=device)
        pos = 0
        for name, shape in specs:
            n = _numel(shape)
            part = flat[pos:pos + n].view(shape)
            pos += n
            if name.endswith("ln.weight"):
                part = 1.0 + 0.1 * part
            else:
                part = 0.02 * part
            out[name] = part.to(dtype)
    return out


def index_rows(seed: int, start: int, count: int, dim: int, device,
               block: int) -> torch.Tensor:
    """Rows [start, start + count) of the corpus's embedding matrix in
    bfloat16, standard normal (the index normalises them).  Row blocks of
    ``block`` rows each come from their own generator, so any block can be
    made again alone."""
    out = []
    b0 = start // block
    b1 = (start + count + block - 1) // block
    for bi in range(b0, b1):
        g = generator(seed, f"rows{bi}", device)
        blk = torch.randn((block, dim), generator=g, device=device)
        lo = max(start, bi * block) - bi * block
        hi = min(start + count, (bi + 1) * block) - bi * block
        out.append(blk[lo:hi].to(torch.bfloat16))
    return torch.cat(out)
