#!/bin/sh
# Config-4 probe-ranking ablation at 12-block scale on the PyTorch/CUDA port
# (counterpart of ablation_cfg4_probe.sh; 12.58M rows, the same 64-row
# cluster density as the 100M run; nlist 4096 = 1.3 sqrt(N)).  Measures
# whether the two block-ranking noise sources, bf16 mini-centroid rounding
# and the ungated noise field, bound the probe-limited recall frontier.
# Probe budgets are the same block fractions as the 100M sweep's
# (2048..8192 of 196608 <=> 256..1024 of 24576).
#
# Departures from the JAX script: it runs from its own checkout (no cd to a
# fixed path); STORE, IDX, ROWS and OUT (the results' directory) come from
# the environment, and their defaults lie under the temporary directory,
# not under benchmark_results/.  Writes a 9.7 GB plane and its index.
set -e
ROOT=$(cd "$(dirname "$0")/.." && pwd)
cd "$ROOT"
export PYTHONPATH=$ROOT${PYTHONPATH:+:$PYTHONPATH}
PYTHON=${PYTHON:-python3}
TMP=${TMPDIR:-/tmp}
STORE=${STORE:-$TMP/archi_host_store/cfg4_12.bf16}
IDX=${IDX:-$TMP/cfg4_12_idx}
ROWS=${ROWS:-12582912}
OUT=${OUT:-$TMP/cfg4_ablation}
mkdir -p "$OUT"

$PYTHON scripts/torch_fill_host_store.py --blocks 12 --threads 8 \
    --sub-rows 65536 --out "$STORE"

# control: the exact r4 production settings (bf16 bc, sub=8, no gate)
$PYTHON scripts/torch_run_config4.py "$OUT/cfg4_12_control.json" \
    --rows $ROWS --nlist 4096 --spill 0.15 --opq 4 \
    --index "$IDX" --store "$STORE" --no-adc \
    --rerank-sweep 256:320,384:320,512:320,768:320,1024:320

# treatment 1: f32 mini-centroids (kills the ~0.3% bf16 ranking noise)
$PYTHON scripts/torch_run_config4.py "$OUT/cfg4_12_f32bc.json" \
    --rows $ROWS --nlist 4096 --spill 0.15 --opq 4 \
    --index "$IDX" --store "$STORE" --no-adc --bc-dtype f32 \
    --rerank-sweep 256:320,384:320,512:320,768:320

# treatment 2: f32 bc + cell gate (shrinks the block-ranking noise field by
# nlist/gate; the gate at the cell fraction the probe budget implies)
$PYTHON scripts/torch_run_config4.py "$OUT/cfg4_12_gate.json" \
    --rows $ROWS --nlist 4096 --spill 0.15 --opq 4 \
    --index "$IDX" --store "$STORE" --no-adc --bc-dtype f32 \
    --rerank-sweep 256:320:1:256,384:320:1:384,512:320:1:512,768:320:1:768
echo ABLATION_DONE
