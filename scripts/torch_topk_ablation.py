#!/usr/bin/env python3
"""Where the tensor-core top-k kernel spends its time, without a profiler.

Builds copies of ``archi_tpu_torch`` whose ``csrc/fused_topk.cu`` has parts
of ``tc_topk_partial_kernel`` taken out, and times each copy on the card at
the flat main path's shapes (2^20 live rows of 384 in a 2^21-row index,
shared bias, k = 10).  The copies compute wrong top-k lists on purpose: only
their times mean anything.

    python3 scripts/torch_topk_ablation.py

Variants (each removes one more part than the one before):
  full          the kernel as committed;
  no_select     no score passes the gate: no candidates, no k-list merges;
  no_epilogue   no scores at all after the products (the products stay);
  loads_only    no products either: the cp.async ring, the ldmatrix loads
                and the barriers.
Needs a CUDA card; run from the root of the repository.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "archi_tpu_torch", "csrc", "fused_topk.cu")

_GATE = "if (v > thr[c & 1] || (v == thr[c & 1] && row < li[qi * k + k - 1])) {"
_EPILOGUE = "    if (ch != nch - 1) continue;"
_PRODUCTS = """        if constexpr (kInt8) {
          tc::mma_s8(acc[n], a[0], b[0], b[1]);
          tc::mma_s8(acc[n], a[1], b[2], b[3]);
        } else {
          tc::mma_bf16(acc[n], a[0], b[0], b[1]);
          tc::mma_bf16(acc[n], a[1], b[2], b[3]);
        }"""
# the fragments stay live, so the loads are not optimised away
_NO_PRODUCTS = "        acc[n][0] += static_cast<Acc>(a[0][0] ^ a[1][1] ^ b[0] ^ b[3]);"
_NO_EPILOGUE = "    if (ch != nch - 1 || acc[0][0] != static_cast<Acc>(12345)) continue;"

VARIANTS = {
    "full": [],
    "no_select": [(_GATE, "if (v > 3e38f) {")],
    "no_epilogue": [(_EPILOGUE, _NO_EPILOGUE)],
    "loads_only": [(_EPILOGUE, _NO_EPILOGUE), (_PRODUCTS, _NO_PRODUCTS)],
}

_TIMER = r"""
import json, sys, torch
from archi_tpu_torch.ops import _build
from archi_tpu_torch.ops.topk import fused_topk, quantize_int8
_build.build(["fused_topk"])
def ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters
g = torch.Generator(device="cuda").manual_seed(0)
e = torch.nn.functional.normalize(torch.randn(1 << 21, 384, device="cuda", generator=g), dim=1)
corpora = {"bfloat16": e.bfloat16(), "int8": quantize_int8(e)}
del e
bias = torch.zeros(1 << 21, device="cuda")
out = {"variant": sys.argv[1]}
for dtype, b in (("bfloat16", 32), ("bfloat16", 256), ("int8", 32)):
    q = torch.nn.functional.normalize(torch.randn(b, 384, device="cuda", generator=g), dim=1)
    out[f"{dtype}_b{b}_ms"] = ms(lambda: fused_topk(q, corpora[dtype], bias, 1 << 20, k=10))
print(json.dumps(out), flush=True)
"""


def make_copy(base: str, name: str, edits) -> str:
    text = open(SOURCE).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the kernel source no longer contains {old!r}")
        text = text.replace(old, new)
    dst = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "archi_tpu_torch"),
                    os.path.join(dst, "archi_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(os.path.join(dst, "archi_tpu_torch", "csrc", "fused_topk.cu"), "w") as f:
        f.write(text)
    return dst


def main() -> int:
    base = tempfile.mkdtemp(prefix="topk_ablation_")
    try:
        rows = []
        for name, edits in VARIANTS.items():
            cwd = make_copy(base, name, edits)
            res = subprocess.run([sys.executable, "-c", _TIMER, name], cwd=cwd,
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
