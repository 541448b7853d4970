#!/usr/bin/env python3
"""Fill the host full-precision tier for BASELINE config 4, on the
PyTorch/CUDA port.

Counterpart of ``scripts/fill_host_store.py``.  The synthetic corpus
(``archi_tpu_torch.benchmarking.synth_corpus``) is generated on the card;
the host exact-rerank tier (``engine/host_store.py``) needs the same rows
host-side, so this script regenerates each block with the shared generator
and copies it into a bf16 memmap, row-aligned with the device index's row
numbering (block-major).  The rows travel as their raw bf16 bits: the
plane holds exactly the bits the ground-truth scan and the index build see.

Resumable: progress is the store's persisted row count; re-running
continues at the next block (a count that is not block-aligned is refused).

Departure from the JAX script: it drains each block through a pool of
relay requests (``--threads`` concurrent ``--sub-rows`` slices), since its
relay was round-trip bound.  The card's copy to the host is local, so there
is no pool: a block is copied ``--sub-rows`` rows at a time on one thread,
which only bounds the host buffer; ``--threads`` is accepted and unused.

Usage (on the card, from the root of the repository):

    python3 scripts/torch_fill_host_store.py [--blocks 96] \
        [--sub-rows 65536] [--out $TMPDIR/archi_host_store/config4.bf16]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "archi_host_store",
                           "config4.bf16")
SUB_ROWS = 1 << 16


def block_bits(blk, sub_rows: int = SUB_ROWS):
    """A bf16 block on any device → its rows as host uint16 bit patterns,
    ``sub_rows`` rows at a time."""
    import torch

    bits = blk.view(torch.int16)
    for s in range(0, bits.shape[0], sub_rows):
        yield bits[s:s + sub_rows].cpu().numpy().view(np.uint16)


def open_store(path: str, n_rows: int, d: int):
    """The bf16 plane at ``path`` (created, or reopened at its persisted
    row count)."""
    from archi_tpu_torch.engine.host_store import BF16, HostVectorStore

    return HostVectorStore(d, path=path, capacity=n_rows, dtype=BF16)


def verify_rows(store, block_fn, rows, block_rows: int) -> None:
    """Assert the plane's ``rows`` equal the generator's bit for bit."""
    import torch

    rows = np.asarray(rows, np.int64)
    for r in rows:
        want = block_fn(int(r // block_rows))[int(r % block_rows)]
        want = want.view(torch.int16).cpu().numpy().view(np.uint16)
        got = np.asarray(store._buf[int(r)])
        assert np.array_equal(got, want), \
            f"plane row {int(r)} != the generator's row (stale fill?)"


def fill(out: str = DEFAULT_OUT, *, blocks: int = 96, block_rows=None,
         sub_rows: int = SUB_ROWS, device=None, log=print) -> dict:
    """Fill ``out`` with ``blocks`` generator blocks (resuming at the
    store's row count), flush, and check sample rows bit for bit.  →
    {rows, blocks_filled, seconds, gb_per_s, verified_rows, path}.
    ``device``: the card unless ``"cpu"``; ``block_rows`` cuts the blocks
    for a dry run (default ``synth_corpus.BLOCK_ROWS``)."""
    from archi_tpu_torch.benchmarking.synth_corpus import (BLOCK_ROWS, D,
                                                           make_block_fn)
    from archi_tpu_torch.utils.hardware import default_device

    dev = default_device(device)
    block_rows = BLOCK_ROWS if block_rows is None else int(block_rows)
    n_total = blocks * block_rows
    store = open_store(out, n_total, D)
    if len(store) % block_rows:
        raise ValueError(f"store row count {len(store)} is not "
                         f"block-aligned; refusing to resume")
    start_block = len(store) // block_rows
    log(f"filling blocks {start_block}..{blocks - 1} "
        f"({(blocks - start_block) * block_rows * D * 2 / 1e9:.1f} GB to "
        f"copy)")
    block_fn = make_block_fn(0, blocks, block_rows=block_rows, device=dev)
    t_start = time.perf_counter()
    for i in range(start_block, blocks):
        t0 = time.perf_counter()
        for part in block_bits(block_fn(i), sub_rows):
            store.add(part)
        store.flush()
        dt = time.perf_counter() - t0
        log(f"block {i}: {dt:.2f}s ({block_rows * D * 2 / 1e6 / dt:.0f} "
            f"MB/s)")
    seconds = time.perf_counter() - t_start
    filled = blocks - start_block
    n = len(store)
    probe = np.unique(np.array([0, 1, n // 3, n // 2, n - 1]))
    verify_rows(store, block_fn, probe, block_rows)
    log(f"done: {n} rows in {out}; sample rows bit-identical")
    return {"rows": n, "blocks_filled": filled, "seconds": seconds,
            "gb_per_s": (filled * block_rows * D * 2 / 1e9
                         / max(seconds, 1e-9)),
            "verified_rows": probe.tolist(), "path": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=96)
    ap.add_argument("--threads", type=int, default=24,
                    help="unused: the card's copy needs no request pool")
    ap.add_argument("--sub-rows", type=int, default=SUB_ROWS,
                    help="rows copied to the host at a time")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    try:
        fill(args.out, blocks=args.blocks, sub_rows=args.sub_rows,
             log=lambda msg: print(msg, flush=True))
    except ValueError as e:
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
