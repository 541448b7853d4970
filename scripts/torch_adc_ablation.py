#!/usr/bin/env python3
"""Where the ADC kernels spend their time, without a profiler.

Builds copies of ``archi_tpu_torch`` whose ``csrc/adc.cu`` has parts of
``adc_kernel`` taken out, and times each copy on the card at the shapes of
the two ANN paths: path A's 8-bit ADC (G = 1, m = 48, S = 360,448) and path
B's 4-bit ADC (G = 2, m = 48 packed into 24 bytes, S = 131,072).  The
copies without lookups or without a table compute wrong scores on purpose:
only their times mean anything.

    python3 scripts/torch_adc_ablation.py [BASELINE_TREE]

BASELINE_TREE, if given, is another checkout of the repository (say the
parent commit, unpacked with ``git archive``) whose kernels are timed the
same way, unchanged, as the variant ``baseline``.

Variants:
  full          the kernel as committed, with the columns a lane that the
                wrapper plans, and again with each width forced (8 and 4
                columns, the 8- and 4-byte loads);
  no_lookups    the codes summed as numbers instead of looked up: the code
                loads, the table prologue and the stores;
  no_prologue   the table left unconverted in shared memory (lookups of
                whatever it holds);
  loads_only    neither: the code loads and the stores.
Each is timed warm (each call after a copy that rewrites the codes, as the
candidate gather leaves them) and cold (each call after a 64 MB write that
flushes the 50 MB L2), from CUDA graphs of ten such pairs with the copy's or
the write's own graph taken off, by ``chip_smoke.graph_ms``.  Needs a
CUDA card; run from the root of the repository.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "archi_tpu_torch", "csrc", "adc.cu")

_LOOKUPS = """      if constexpr (PACKED) {
        // subspace 2r (low nibble), then 2r + 1 (high nibble)
        add_entry<GT, CPT>(acc, k, row[byte & 15u]);
        add_entry<GT, CPT>(acc, k, row[16 + (byte >> 4)]);
      } else {
        add_entry<GT, CPT>(acc, k, row[byte]);
      }"""
_NO_LOOKUPS = "      acc[0][k] += static_cast<float>(byte);"
_PROLOGUE = [("  const bool quads = (ksub & 3) == 0;", "  const bool quads = false;"),
             ("    fill_table_scalar<GT>(tab, luts, G, g0, ksub, j0, mc);", "")]

VARIANTS = {
    "full": [],
    "no_lookups": [(_LOOKUPS, _NO_LOOKUPS)],
    "no_prologue": _PROLOGUE,
    "loads_only": [(_LOOKUPS, _NO_LOOKUPS)] + _PROLOGUE,
}

_TIMER = r"""
import importlib.util, json, sys, torch
from archi_tpu_torch.ops import adc
# the timer of this repository's chip_smoke.py, whichever tree is timed
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
def graph_ms(fn):
    # ten calls a graph: the card, not the host's replay, sets the pace
    return smoke.graph_ms(fn, calls=10)
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
g = torch.Generator(device="cuda").manual_seed(0)
cases = {"adc8_g1_m48_s360448": (48, 1, 360448, False),
         "adc4_g2_m48_s131072": (48, 2, 131072, True)}
variant = sys.argv[1]
# a tree without the launch plan (the first port's kernels) times as it is
plan = getattr(adc, "columns_per_lane", None)
out = {"variant": variant}
for name, (m, gq, s, packed) in cases.items():
    ksub = 16 if packed else 256
    luts = torch.randn(m, gq, ksub, device="cuda", generator=g)
    src = torch.randint(0, 256 if packed else ksub, (m // 2 if packed else m, s),
                        device="cuda", generator=g, dtype=torch.uint8)
    codes = src.clone()
    kernel = adc.adc_scores_lut16 if packed else adc.adc_scores
    # the planned width, then each width forced (full variant)
    widths = [None] + ([8, 4] if variant == "full" and plan else [])
    for cols in widths:
        key = name + ("" if cols is None else f"_cols{cols}")
        if plan:
            adc.columns_per_lane = plan if cols is None else (lambda *a, c=cols: c)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out[key + "_cols"] = cols or plan(s, gq, codes.data_ptr(), sms)
        call = lambda: kernel(luts, codes)
        out[key + "_warm_ms"] = (graph_ms(lambda: (codes.copy_(src), call()))
                                 - graph_ms(lambda: codes.copy_(src)))
        out[key + "_cold_ms"] = (graph_ms(lambda: (flush.zero_(), call()))
                                 - graph_ms(lambda: flush.zero_()))
    if plan:
        adc.columns_per_lane = plan
print(json.dumps(out), flush=True)
"""

_BUILD = ("from archi_tpu_torch.ops import _build; _build.build(['adc']); "
          "print(_build.BUILD_LOGS.get('adc', ''))")


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
    with open(os.path.join(dst, "archi_tpu_torch", "csrc", "adc.cu"), "w") as f:
        f.write(text)
    return dst


def main() -> int:
    base = tempfile.mkdtemp(prefix="adc_ablation_")
    try:
        dirs = {name: make_copy(base, name, edits)
                for name, edits in VARIANTS.items()}
        if len(sys.argv) > 1:       # a baseline tree, timed unchanged
            dirs["baseline"] = os.path.abspath(sys.argv[1])
        # build every copy at once, then time them one after the other
        builds = {name: subprocess.Popen([sys.executable, "-c", _BUILD], cwd=cwd,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                  for name, cwd in dirs.items()}
        for name, proc in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: build failed\n{log}", file=sys.stderr)
                return proc.returncode
        for name, cwd in dirs.items():
            res = subprocess.run([sys.executable, "-c", _TIMER, name,
                                  os.path.join(ROOT, "chip_smoke.py")],
                                 cwd=cwd, capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            print(json.dumps(json.loads(res.stdout.strip().splitlines()[-1])),
                  flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
