#!/usr/bin/env python3
"""Out-of-process ANN snapshot builder on the PyTorch/CUDA port.

Counterpart of ``scripts/ann_builder.py``, with its flags and its output
files.  A background in-process IVF / IVF-PQ rebuild competes with serving
for the device; instead the serving process exports its corpus
(``AnnFlatIndex.export_corpus``), this process builds the snapshot — on
another card, or on the CPU with ``--device cpu`` — and writes the standard
sidecar, and the serving process calls ``adopt_snapshot`` to swap it in
(epoch-checked, so a compaction since the export refuses the stale row
numbering).  The npz layout is the JAX package's, so either package's
builder serves either package's index.

Departure from the JAX script: ``--device cpu|cuda`` (default cuda) names
the torch device; the JAX flag ``--platform`` is accepted as its alias.

Usage:

    python3 scripts/torch_ann_builder.py --corpus /path/prefix
        [--kind ivf|ivfpq] [--nlist 1024] [--device cpu|cuda]
        [--pq-m 48] [--pq-refine-m 48]

Writes ``<prefix>.ann.npz`` + ``<prefix>.ann.json`` next to the export.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run(corpus: str, *, kind=None, nlist: int = 1024, pq_m: int = 48,
          pq_refine_m: int = 48, device=None, log=print) -> dict:
    """Build the snapshot of the export at ``corpus`` and write its sidecar
    → ``{"n_snap", "kind", "seconds", "device"}``.  ``device``: the card
    unless ``"cpu"``."""
    import numpy as np
    import torch

    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    with open(corpus + ".export.json") as f:
        exp = json.load(f)
    kind = kind or exp.get("kind", "ivf")
    with np.load(corpus, allow_pickle=False) as z:
        n = int(exp["n_rows"])
        x = torch.as_tensor(np.asarray(z["emb"][:n], np.float32), device=dev)
    log(f"building {kind} snapshot: {n} rows x {x.shape[1]}d on {dev}")
    t0 = time.time()
    nlist = max(1, min(nlist, n))
    if kind == "ivfpq":
        from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex

        ivf = IVFPQIndex.build_device(x, nlist=nlist, block=512, m=pq_m,
                                      refine_m=pq_refine_m)
    else:
        from archi_tpu_torch.engine.ivf_index import IVFIndex

        ivf = IVFIndex.build_device(x, nlist=nlist, block=512)
    ivf.save(corpus + ".ann.npz")
    with open(corpus + ".ann.json", "w") as f:
        json.dump({"n_snap": n, "kind": kind}, f)
    secs = time.time() - t0
    log(f"snapshot built in {secs:.1f}s -> {corpus}.ann.npz")
    return {"n_snap": n, "kind": kind, "seconds": secs, "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True,
                    help="prefix written by AnnFlatIndex.export_corpus")
    ap.add_argument("--kind", default=None, choices=[None, "ivf", "ivfpq"])
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--pq-m", type=int, default=48)
    ap.add_argument("--pq-refine-m", type=int, default=48)
    ap.add_argument("--device", "--platform", dest="device", default=None,
                    help="torch device (default cuda; cpu builds away from "
                         "the serving card)")
    args = ap.parse_args()
    run(args.corpus, kind=args.kind, nlist=args.nlist, pq_m=args.pq_m,
          pq_refine_m=args.pq_refine_m, device=args.device,
          log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    # script-mode sys.path[0] is scripts/: make archi_tpu_torch importable
    # without relying on the parent process's PYTHONPATH
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
