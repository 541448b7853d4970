#!/usr/bin/env python3
"""Attention re-fold experiment on the PyTorch/CUDA port: can the small-K
attention dots (head dim 32) be made faster by folding them into K = H
products, or by int8 dots?

Counterpart of ``scripts/bench_attention_refold.py``, with its shape, its
variants and its payload keys.  One attention layer at B 256, S 256, H 384,
12 heads (MiniLM-L6's; the encoder's ingest batch), in three forms:

1. ``baseline``: the q, k, v, o projections and per-head dots of K = 32;
2. ``folded``: per head, ``logits_n = X A_n Xᵀ`` with the static ``A_n =
   Wq_n Wk_nᵀ [H, H]`` and ``ctx = Σ_n P_n (X W'_n)`` with ``W'_n = Wv_n
   Wo_n``, precomposed once: every runtime product has K = 384, at 12× the
   FLOPs of the dots they replace;
3. ``int8``: the projections in bf16, both attention dots in int8 with a
   max-abs scale a (batch, head), through ``torch._int_mm``.  ``_int_mm`` is
   2-D, so the batched dots loop over the B·nh (batch, head) pairs, one
   ``_int_mm`` each for QKᵀ and PV: the form times the dots and the
   launches of that loop together.

Then the dots alone: 64 serially dependent steps of the QKᵀ logits at K = 32
against the folded K = 384 ones, each step's small operand nudged by a
nonlinear reduction of the previous logits (tanh, then a mean), so no step
can be skipped or merged.

All of it runs as plain PyTorch products (no custom kernel: the JAX script
runs no Pallas kernel either), bf16 on the tensor cores with f32
accumulation, timed with CUDA events: each layer chained on its previous
output, best of 3 trials of 16 steps.  The numbers are the card's;
``PERF.md`` gives them with the card's name and power limit.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_bench_attention_refold.py
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

B, S, H, NH = 256, 256, 384, 12
STEPS, TRIALS = 16, 3
K_SCAN = 64
#: how far (``rel_err``) the folded and the int8 forms may lie from the
#: baseline: two bf16 steps (each bf16 form is about 0.005 from an f64
#: layer), and 1/8 for int8 (the probabilities quantised at 1/127 of each
#: head's largest; about 0.06 from an f64 layer)
BF16_TOL = 2.0 ** -6
INT8_TOL = 2.0 ** -3


def rel_err(got, want) -> float:
    """‖got − want‖ / ‖want‖ over all elements, in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def make_inputs(b=B, s=S, h=H, *, device, seed: int = 0) -> dict:
    """x [b, s, h] and the four [h, h] projections, bf16 normals from a
    ``torch.Generator`` seeded ``seed`` (the weights scaled by 0.05)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale) \
            .to(torch.bfloat16)

    return {"x": normal(b, s, h), "wq": normal(h, h, scale=0.05),
            "wk": normal(h, h, scale=0.05), "wv": normal(h, h, scale=0.05),
            "wo": normal(h, h, scale=0.05)}


def heads(t, nh: int):
    """[B, S, H] → [B, nh, S, hd]."""
    b, s, h = t.shape
    return t.reshape(b, s, nh, h // nh).transpose(1, 2)


def _softmax_bf16(logits, hd: int):
    import torch

    return torch.softmax(logits / math.sqrt(hd), dim=-1).to(torch.bfloat16)


def baseline(x, w: dict, nh: int = NH):
    """The q, k, v, o projections and the per-head K = hd dots."""
    b, s, h = x.shape
    hd = h // nh
    q, k, v = heads(x @ w["wq"], nh), heads(x @ w["wk"], nh), \
        heads(x @ w["wv"], nh)
    p = _softmax_bf16((q @ k.transpose(-1, -2)).float(), hd)
    ctx = (p @ v).transpose(1, 2).reshape(b, s, h)
    return ctx @ w["wo"]


def fold_weights(w: dict, nh: int = NH):
    """The static per-head ``A_n = Wq_n Wk_nᵀ`` and ``W'_n = Wv_n Wo_n``,
    [nh, H, H] each, composed in f32 and kept in bf16."""
    import torch

    h = w["wq"].shape[0]
    hd = h // nh

    def per_head(t):                         # [H, H] → [nh, H, hd]
        return t.float().reshape(h, nh, hd).transpose(0, 1)

    a_fold = per_head(w["wq"]) @ per_head(w["wk"]).transpose(1, 2)
    w_fold = per_head(w["wv"]) @ w["wo"].float().reshape(nh, hd, h)
    return a_fold.to(torch.bfloat16), w_fold.to(torch.bfloat16)


def folded(x, a_fold, w_fold):
    """Every runtime product at K = H."""
    import torch

    nh, h, _ = a_fold.shape
    y = torch.einsum("bse,hef->bhsf", x, a_fold)        # nh big products
    logits = (y @ x[:, None].transpose(-1, -2)).float()  # [B, nh, S, S]
    p = _softmax_bf16(logits, h // nh)
    vp = torch.einsum("bse,hef->bhsf", x, w_fold)       # [B, nh, S, H]
    return torch.einsum("bhst,bhtf->bsf", p, vp)


def quantize(t):
    """Symmetric int8 with one max-abs scale a (batch, head) → (int8, f32
    scale [..., 1, 1])."""
    import torch

    s = t.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
    return torch.clamp(torch.round(t / s), -127, 127).to(torch.int8), s


def int8_dots(a, b_t):
    """[P, m, k] int8 @ [P, k, n] int8 → [P, m, n] int32, one ``_int_mm``
    a pair; ``b_t`` is passed as the transpose of a contiguous [P, n, k]
    (the layout ``_int_mm`` takes)."""
    import torch

    return torch.stack([torch._int_mm(a[i], b_t[i].transpose(0, 1))
                        for i in range(a.shape[0])])


def int8_attn(x, w: dict, nh: int = NH):
    """bf16 projections, int8 QKᵀ and PV."""
    import torch

    b, s, h = x.shape
    hd = h // nh
    q, k, v = heads(x @ w["wq"], nh), heads(x @ w["wk"], nh), \
        heads(x @ w["wv"], nh)
    qi, qs = quantize(q.float())
    ki, ks = quantize(k.float())
    pairs = b * nh
    logits = int8_dots(qi.reshape(pairs, s, hd),
                       ki.reshape(pairs, s, hd).contiguous())
    logits = logits.reshape(b, nh, s, s).float() * (qs * ks)
    p = torch.softmax(logits / math.sqrt(hd), dim=-1)
    pi, ps = quantize(p)
    vi, vs = quantize(v.float())
    ctx = int8_dots(pi.reshape(pairs, s, s),
                    vi.reshape(pairs, s, hd).transpose(1, 2).contiguous())
    ctx = (ctx.reshape(b, nh, s, hd).float() * (ps * vs)).to(torch.bfloat16)
    return ctx.transpose(1, 2).reshape(b, s, h) @ w["wo"]


def scan_small(q, k, steps: int = K_SCAN):
    """``steps`` serially dependent K = hd logits products; the carry is k."""
    import torch

    for _ in range(steps):
        lg = (q @ k.transpose(-1, -2)).float()
        d = torch.tanh(lg).mean(dim=2)[..., None] * 1e-6
        k = k + d.to(k.dtype)
    return k[0, 0, 0].float().sum()


def scan_big(y, x, steps: int = K_SCAN):
    """The same at K = H over the folded ``y``; the carry is x."""
    import torch

    for _ in range(steps):
        lg = (y @ x[:, None].transpose(-1, -2)).float()
        d = torch.tanh(lg).mean(dim=(1, 2))[..., None] * 1e-6
        x = x + d.to(x.dtype)
    return x[0, 0].float().sum()


def _timer(dev):
    """→ a function that runs ``fn`` and returns its seconds (CUDA events
    on the card, the host clock elsewhere)."""
    import torch

    def timed(fn):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return timed


def measure(b: int = B, s: int = S, h: int = H, nh: int = NH, *,
            steps: int = STEPS, trials: int = TRIALS, k_scan: int = K_SCAN,
            device=None, log=print):
    """The three layer forms and the two dot scans → ``(payload, state)``:
    the JAX script's payload and ``state``: the inputs, the folded weights
    and each form's output on ``x``.  ``device``: the card unless
    ``"cpu"``."""
    import torch

    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    hd = h // nh
    w = make_inputs(b, s, h, device=dev)
    x = w.pop("x")
    a_fold, w_fold = fold_weights(w, nh)
    timed = _timer(dev)

    def best(fn, x0):
        fn(x0)                                   # warm-up
        out = float("inf")
        for _ in range(trials):
            def chain():
                o = x0
                for _ in range(steps):
                    o = fn(o)
                float(o[0, 0, 0])
            out = min(out, timed(chain))
        return out / steps

    forms = {"baseline_xla": lambda t: baseline(t, w, nh),
             "folded_bigK": lambda t: folded(t, a_fold, w_fold),
             "int8_dots": lambda t: int8_attn(t, w, nh)}
    results = {"shape": f"B{b} S{s} H{h} nh{nh} hd{hd}", "variants": {},
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
    with torch.inference_mode():
        outputs = {name: fn(x) for name, fn in forms.items()}
        for name, fn in forms.items():
            dt = best(fn, x)
            results["variants"][name] = {
                "ms_per_layer_attention": round(dt * 1e3, 3)}
            log(f"{name} {results['variants'][name]}")

        k0, q0 = heads(x @ w["wk"], nh), heads(x @ w["wq"], nh)
        y0 = torch.einsum("bse,hef->bhsf", x, a_fold)

        def scan_best(run):
            run()
            return min(timed(run) for _ in range(trials)) / k_scan

        useful = 2 * b * nh * s * s * hd
        dt_small = scan_best(lambda: float(scan_small(q0, k0, k_scan)))
        results["variants"]["qk_dots_smallK"] = {
            "ms": round(dt_small * 1e3, 4),
            "useful_tflops_lower_bound": round(useful / dt_small / 1e12, 2)}
        dt_big = scan_best(lambda: float(scan_big(y0, x, k_scan)))
        results["variants"]["qk_dots_foldedK384"] = {
            "ms": round(dt_big * 1e3, 4),
            "useful_tflops_lower_bound": round(useful / dt_big / 1e12, 2),
            "note": f"same useful logits, K={h} contraction, {h // hd}x raw "
                    f"FLOPs; both scans also read the [B, nh, S, S] f32 "
                    f"logits once a step for the carry — the small-vs-big "
                    f"difference isolates the dot"}
    log(json.dumps(results, indent=1))
    state = {"x": x, "w": w, "a_fold": a_fold, "w_fold": w_fold,
             "outputs": outputs}
    return results, state


def run(**kw) -> dict:
    """``measure`` → its payload."""
    return measure(**kw)[0]


def main() -> None:
    run(log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
