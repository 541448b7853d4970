#!/usr/bin/env python3
"""Encoder throughput benchmark on the PyTorch/CUDA port.

Counterpart of ``scripts/bench_encoder.py``, with its arguments and printed
figures.  Times the BERT forward (the embed hot loop of ingest) in bf16 with
the plain attention (``attention_impl="plain"``, the JAX script's ``"xla"``)
and then with the attention kernel (``"kernel"``, its ``"pallas"``), at
MiniLM-L6, bge-small or bge-base widths, random weights from seed 0.

Measurement rules, as in the JAX script: the inputs are made on the card,
each step's ids are derived from the previous step's output (fixed noise
plus an offset read from it on the card), and the steps are timed with CUDA
events after a warm-up at the timed shape.  TFLOP/s counts the matmul FLOPs
of ``model_flops`` (the JAX script's) and is given beside the H100's dense
bf16 peak, 989 TFLOP/s at 700 W (NVIDIA's data sheet); ``PERF.md`` gives the
times with the card's name and power limit.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_bench_encoder.py [batch] [seq] [steps] [model]

``model``: ``minilm`` (default), ``bge-small`` or ``bge-base``.
"""

from __future__ import annotations

import json
import os
import sys
import time

#: H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
PEAK_BF16_TFLOPS = 989.0
IMPLS = ("plain", "kernel")


def model_flops(cfg, b: int, s: int) -> float:
    """Matmul FLOPs of one forward (2 FLOPs per MAC)."""
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    tokens = b * s
    linear = 2 * tokens * (4 * h * h + 2 * h * f)     # qkvo + ffn
    attn = 2 * tokens * 2 * s * h                      # qk^T + pv
    return L * (linear + attn)


def config_of(model: str):
    from archi_tpu_torch.models.bert import BertConfig

    return (BertConfig.bge_base() if model == "bge-base"
            else BertConfig.bge_small() if model == "bge-small"
            else BertConfig.minilm_l6())


def make_model(cfg, *, device):
    """A bf16 ``BertEncoder`` with seed-0 random weights (the JAX package's
    ``init_params`` draws)."""
    import torch

    from archi_tpu_torch.models.bert import BertEncoder, init_params
    from archi_tpu_torch.models.hf_loader import params_from_jax

    return BertEncoder.from_state(
        cfg, params_from_jax(init_params(cfg, seed=0)), device=device,
        compute_dtype=torch.bfloat16)


class Chain:
    """The JAX script's ``ids_from``: fixed noise ids plus an offset taken
    from the previous output, all on the device."""

    def __init__(self, vocab: int, batch: int, seq: int, device):
        import torch

        g = torch.Generator(device=device).manual_seed(0)
        self.noise = torch.randint(0, vocab, (batch, seq), device=device,
                                   generator=g)
        self.vocab = vocab
        self.mask = torch.ones((batch, seq), dtype=torch.int64,
                               device=device)

    def ids_from(self, seed_vec):
        offset = (seed_vec[0, 0].abs() * 1000).long()
        return (self.noise + offset) % self.vocab


def bench(impl: str, model, chain: Chain, steps: int):
    """Seconds a forward at ``attention_impl=impl``: the mean over ``steps``
    chained steps after a warm-up → (seconds, last output)."""
    import torch

    from archi_tpu_torch.models.bert import encode

    dev = chain.noise.device
    out = torch.ones((chain.noise.shape[0], model.config.hidden_size),
                     dtype=torch.float32, device=dev)
    out = encode(model, chain.ids_from(out), chain.mask,
                 attention_impl=impl)
    float(out.sum())
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            out = encode(model, chain.ids_from(out), chain.mask,
                         attention_impl=impl)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / steps, out
    t0 = time.perf_counter()
    for _ in range(steps):
        out = encode(model, chain.ids_from(out), chain.mask,
                     attention_impl=impl)
    float(out.sum())
    return (time.perf_counter() - t0) / steps, out


def measure(batch: int = 256, seq: int = 256, steps: int = 8,
            model: str = "minilm", *, device=None, log=print):
    """Both attention routes → ``(payload, state)``: each route's ms a
    batch, Mtok/s, seq/s, matmul TFLOP/s and its share of the bf16 peak;
    ``state``: ``model``, ``chain`` and each route's last output
    (``outputs``).  ``device``: the card unless ``"cpu"``."""
    import torch

    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    cfg = config_of(model)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    log(f"model={model} H={cfg.hidden_size} L={cfg.num_layers} "
        f"hd={cfg.head_dim}")
    enc = make_model(cfg, device=dev)
    chain = Chain(cfg.vocab_size, batch, seq, dev)
    flops = model_flops(cfg, batch, seq)
    toks = batch * seq
    payload = {"model": model, "batch": batch, "seq": seq, "steps": steps,
               "hidden": cfg.hidden_size, "layers": cfg.num_layers,
               "head_dim": cfg.head_dim, "matmul_flops": flops,
               "peak_bf16_tflops": PEAK_BF16_TFLOPS,
               "device": name, "routes": {}}
    outputs = {}
    for impl in IMPLS:
        dt, outputs[impl] = bench(impl, enc, chain, steps)
        tflops = flops / dt / 1e12
        payload["routes"][impl] = {
            "ms_per_batch": round(dt * 1e3, 3),
            "mtok_per_s": round(toks / dt / 1e6, 3),
            "seq_per_s": round(batch / dt, 1),
            "matmul_tflops": round(tflops, 2),
            "share_of_bf16_peak": round(tflops / PEAK_BF16_TFLOPS, 4)}
        log(f"{impl:8s} b={batch} s={seq}: {dt * 1e3:8.2f} ms/batch  "
            f"{toks / dt / 1e6:6.2f} Mtok/s  {batch / dt:8.0f} seq/s  "
            f"{tflops:6.1f} TFLOP/s (matmul)")
    return payload, {"model": enc, "chain": chain, "outputs": outputs}


def run(batch: int = 256, seq: int = 256, steps: int = 8,
        model: str = "minilm", **kw) -> dict:
    """``measure`` → its payload."""
    return measure(batch, seq, steps, model, **kw)[0]


def main() -> None:
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    seq = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    model = sys.argv[4] if len(sys.argv) > 4 else "minilm"
    print(json.dumps(run(batch, seq, steps, model,
                         log=lambda m: print(m, flush=True))))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
