#!/bin/sh
# Second config-4 probe-ranking ablation wave on the PyTorch/CUDA port
# (counterpart of ablation_cfg4_probe2.sh; runs on the index and plane that
# torch_ablation_cfg4_probe.sh saved).  Tests the spill-alignment
# hypothesis: probe-spill appends boundary rows to their second cell's
# blocks after the cell's own rows, so 64-row sub-centroids (sub=8 at
# block=512) are no longer cluster-pure; sub=16 (32-row granularity)
# restores one mini-centroid a cluster.  Also the QPS side: hier_t=32 halves
# the final merge width against 64, at a recall cost measured here.
#
# Departures from the JAX script: as torch_ablation_cfg4_probe.sh (its own
# checkout; STORE, IDX, ROWS and OUT from the environment, defaults under
# the temporary directory).
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

# treatment 3: f32 bc + sub=16
$PYTHON scripts/torch_run_config4.py "$OUT/cfg4_12_sub16.json" \
    --rows $ROWS --nlist 4096 --spill 0.15 --opq 4 \
    --index "$IDX" --store "$STORE" --no-adc --bc-dtype f32 --sub 16 \
    --rerank-sweep 256:320,384:320,512:320,768:320

# treatment 4: QPS lever — hier_t=32 at the recall frontier points
$PYTHON scripts/torch_run_config4.py "$OUT/cfg4_12_hier32.json" \
    --rows $ROWS --nlist 4096 --spill 0.15 --opq 4 \
    --index "$IDX" --store "$STORE" --no-adc --bc-dtype f32 --hier-t 32 \
    --rerank-sweep 512:320,768:320
echo ABLATION2_DONE
