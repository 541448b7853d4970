#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's hybrid-retrieval main path on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each fails the run with a non-zero exit):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels of ``archi_tpu_torch/csrc`` from source, logging each
     kernel's registers, spills and static shared memory (ptxas), and the
     native text analyzer (``archi_tpu_torch/native``, g++) beside them;
     the run fails if the analyzer does not load;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives them (2^20 live rows of 384 in a 2^21-row
     index; MiniLM-L6's attention at the ingest and query buckets) and a
     few more, and time kernel (CUDA graph and CUDA events), plain version
     and a one-call PyTorch yardstick (``torch._int_mm`` for int8 top-k);
  3. run the main path through ``TorchVectorStore`` over a MiniLM-L6
     ``TorchEmbedder`` at full width (random weights from a seed): ingest
     documents through the encoder, fill the index to 2^20 rows, run
     semantic and hybrid searches, check them against a brute-force scan of
     the same tensors, and check that both kernels' launch counters rose
     during that run, every launch on the tensor-core route (the index and
     the encoder are bf16), while the top-k fallback counter stayed at 0,
     and that every document and query took the native analyzer and
     WordPiece encoder;
  4. time the encoder and the query paths with CUDA events, and ingest's
     stages over 1024 documents on both routes of the text analysis (the
     native library, then the Python functions), with the ingest rate of
     each;
  5. path A, ``type: ivfpq`` serving: ``TorchVectorStore`` over
     ``AnnFlatIndex(snapshot_kind="ivfpq")`` at the bootstrap's defaults,
     documents through the encoder and a clustered corpus filled to 2^22
     rows, the snapshot built, searched through the 8-bit ADC kernel and
     the fresh tail, and checked (self-retrieval, kernel against the plain
     ADC, filter, recall@10 against the exact scan, fresh rows, a
     save/load round trip of the snapshot);
  6. path B, the XL tier's snapshot: ``IVFPQIndex.build_streaming`` over
     the same rows with packed 4-bit codes, block-budget probing through the
     4-bit ADC kernel and the host exact rerank, checked the same way;
  7. the service layer, through ``archi_tpu_torch.bin.bootstrap``'s
     ``build_vectorstore``: (a) phase 3's encoder written as a local HF
     snapshot and its store as ``engine_checkpoint``, restored with
     micro-batching at the defaults and served to 64 concurrent clients
     (512 hybrid requests, each held against the direct path), then the
     top 50 hybrid candidates of 8 queries reranked by ``MaxSimReranker``
     (against the same weights on the CPU); (b) the same checkpoint restored
     as a hot-tail index, 1024 documents ingested into the tail and merged
     while 64 clients query; (c) ``type: ivfpq_xl`` at the bootstrap's
     defaults, 2^20 clustered rows, a snapshot, 4096 documents in the exact
     tail, micro-batched hybrid and semantic queries, recall, exact scores
     and a save/load round trip; (d) the port's data-manager service over
     HTTP (``bin/service_data_manager.build_app``, flat bf16, micro-batching
     at the defaults): 4,096 local files of about 4 KB (cut from 16,384)
     ingested by its initial ingestion (every file ``embedded``, the count equal to the corpus's
     chunks, the index at phase 2's top-k shape), 64 clients x 8 ``POST
     /api/query/hybrid`` through
     ``urllib``, each answer equal to the direct path, a restart that
     restores the checkpoint with a zero diff and the same top-10, then
     semantic queries, 16 uploads and a resync, a delete, ``/metrics`` and
     the ``DATA_MANAGER_TOKEN`` gate; (e) before 7d's restart, the port's
     chat service on 7d's live data-manager (``bin/service_chat.build_app``
     in remote mode on 7d's config with ``services.chat.engine_url``):
     32 clients x 4 ``POST /api/get_chat_response`` over ``urllib`` at the
     config's ``QAPipeline`` (echo models, hybrid k=5), half of the
     clients in one conversation each, every answer's sources equal to the
     direct hybrid search of its condensed query on 7d's store; the stream,
     the history, feedback, document selection, the proxied
     ``/api/dm/status``, BYOK (501 without ``cryptography``) and
     ``/metrics``; the ReAct agent over the remote store, its model
     scripted to search once; then 8 chats in-process over 7d's store with
     the MaxSim rerank (over-fetch 20), each equal to the direct rerank,
     and the shape of every kernel launch of 7e logged; (f) before 7d's
     restart too, the port's other entry points: the grader
     (``bin/service_grader.build_app`` over a context that takes 7d's
     store) grading 16 submissions at once over HTTP, each grade's sources
     equal to the direct semantic search, an account from
     ``service_create_account`` whose password verifies, the Mattermost and
     Piazza bots answering 16 questions each in one ``step()`` and the
     Redmine processor drafting 8 tickets (its agent scripted to search
     once), every answer's sources equal to the direct hybrid search; then
     ``bin/service_benchmark`` on a config of its own (the fixture corpus
     as local files, phase 3's encoder, flat bf16, SOURCES and RETRIEVAL),
     ``evaluate --fixture`` and ``--beir`` through the port's CLI on the
     card and on the CPU (the same totals, recall@10 at least 0.99), and
     ``create`` through ``cli/deployment.DeploymentManager``: the
     data-manager and the chat as processes on the card over 256 of 7d's
     files, queried and chatted with over HTTP (0 top-k fallbacks in their
     ``/metrics``), then ``delete``;
  8. the trainer (``models/train_encoder.py``) at MiniLM-L6's widths over
     phase 3's first 1024 documents: step 0 at f32 on the card against the
     CPU (loss and gradients, 1e-4 relative), 100 bf16 steps (the loss
     falls, every attention launch on the tensor cores), then the export
     served through ``build_vectorstore``: query views of 64 documents
     find their document at rank 1 (at least 0.75);
  9. the multi-device tier, four logical shards on the card: (a)
     ``ShardedFlatIndex`` against one ``FlatIndex`` over 2^22 rows (3 GiB
     of bf16 each), added in blocks across the seams, with tombstones and
     a filter, at B=32 / 256 (shared bias) and B=32 (per-query bias), then
     growth past the capacity (rows move shard): scores within 1e-6, rows
     tie-aware; (b) a one-rank NCCL group from ``initialize_distributed``,
     through which 9a's searches run ``all_gather`` and equal 9a's results
     bit for bit; (c) ``ShardedIVFIndex`` and ``ShardedIVFPQIndex`` over
     phase 5's clustered rows at path A's parameters, recall@10 at least
     0.6; (d) ``type: ivfpq_xl_sharded`` through ``build_vectorstore`` at
     the bootstrap's defaults over 7c's 2^20 clustered rows, 64 clients x
     8 micro-batched hybrid requests equal to the direct path, recall@10
     at least 0.9, scores within 1e-4 of the host rows, the profile split,
     save/load and ``adopt_stores`` over ``HostVectorStore.view`` windows;
     (e) the data-parallel encode (``TorchEmbedder(devices=...)``) against
     one device (cosine at least 0.9999);
 10. BASELINE configs 3 and 5 and the sweep tooling through the port's
     ``benchmarking`` modules and ``scripts/torch_*.py``: (a)
     ``torch_run_config3.run`` over 8,802,304 x 768 bf16 rows (13.5 GB)
     made by ``synthetic_corpus_device``, self-recall 1.0, one B=32 batch
     equal to a chunked f32 exact scan (tie-aware, 1e-4); (b) config 5's
     phase A (``torch_bench_streaming_ingest.phase_vector``), 2^23 - 2^17
     rows in a 2^23-row index, 1024-row batches every 2 s for 20 s (cut
     from 45 s) under B=32 queries: at
     least 10,000 rows/min, no growth,
     one row of every batch read back at rank 1; (c) its phase B at 2^20
     rows with 200,000 live BM25 documents: no full BM25 build during the
     stream, a final hybrid query equal to brute force, every text through
     the native analyzer; (d) ``ivf_sweep.run_sweep`` on the card over 2^22
     rows (nlist 2048, nprobe 4-2048): recall non-decreasing and 1.0 at the
     full probe; ``pq_sweep.run_pq_sweep`` (IVF-PQ, flat PQ, the fixture's
     embeddings): recall_in_100 >= recall_strict; (e)
     ``synth_corpus.make_block_fn``: a 2^20 x 384 block pure in (seed, i),
     unit norm within 1e-2, 64 +- 2 rows a cluster.  Part 7c also checks
     that no background refresh failed during its fill;
 11. BASELINE config 4 on one card through ``scripts/torch_*.py``, at 8
     generator blocks of 2^20 rows (2^23 rows, a 6.4 GB bf16 plane; the JAX
     script's ``--quick``), cut from config 4's 96 blocks (100,663,296 rows)
     for the time limit: 16 blocks took this phase to 320 s and the run to
     1,229 s on one host.  (a) ``torch_fill_host_store.fill`` of the plane
     under ``.chip_tmp/config4``, its rate, ``free -g`` and ``df -h``, and
     21 rows bit for bit against the generator; (b)
     ``torch_run_config4.measure`` over it at the JAX r05 build (nlist
     16384, block 512, m 96 + 96, spill 0.15, OPQ 4): its GT scan equal to
     a chunked plain f32 exact scan (tie-aware, 1e-4), the host rerank's
     scores equal to exact products with the host rows (1e-4), self_top1
     1.0 at the largest rerank budget, the headline's recall_score_at_10 at
     least 0.99, the ADC-only recall not falling as nprobe rises; (c)
     ``torch_run_config4_sharded.measure``, 4 logical shards over the same
     plane: recall@10 at least 0.9 at the largest budget, scores equal to
     the host rows (1e-4), the comparison with (b) at equal budgets logged;
     (d) ``torch_bench_shard_scaling.measure`` at 2^20 rows, its flat tier:
     each sharded search equal to one index (1e-6, tie-aware) and its
     scan-only shards, merged, equal to it.  Every top-k launch of (b)-(d)
     takes its planned route (the CUDA-core kernel over f32 blocks, the
     tensor cores over bf16), every ADC launch the vectorised one, with no
     top-k fallback; each part logs the shapes it launched the kernels at.
     11b's index and the plane are kept for 12h;
 12. the ported measurement and tooling scripts (``scripts/torch_*.py``)
     through their ``measure`` / ``run``, each part counted, its shapes
     logged, within about 150 s, cut for the time limit: (a)
     ``torch_bench_serving`` in both modes over 2^20 x 384 bf16, 64 clients
     x 8 requests (cut from 256 x 40), batches 32, 128, 256: 64 sampled
     answers of each run equal a direct single-query top-k (tie-aware,
     1e-4), and the in-process batch function makes no host sync in steady
     state; (b) ``torch_bench_serving_http`` on the card, 4,096 chunks (cut
     from 10,000: the hash featurizer's host ingest took 8 s), 64 clients x
     4 (cut from 256 x 20): every status 200, 32 sampled answers of each
     hybrid wave equal ``store.hybrid_search`` (1e-4); (c)
     ``torch_bench_ingest`` at 16,384 chunks (cut from 100,000): count and
     BM25 documents equal n, the final hybrid answer equals phase 3's brute
     force; (d) ``torch_bench_encoder`` at b256 s256, MiniLM-L6 and
     bge-base: the kernel route's output within 2^-7 of the plain route's;
     (e) ``torch_run_quality --encoder both`` at 100 training steps (cut
     from 1,500): the hash section equal to a CPU run's, the loss falling;
     (f) ``torch_exp_encoder --hash-only`` (equal to (e)'s ablations) and a
     trained tag at 50 steps; (g) ``torch_ann_builder --kind ivfpq --nlist
     1024`` in a subprocess on the card over a 2^18-row clustered export,
     and one on the CPU over a 2^15-row one (cut from 2^18: that build
     took 325 s on the card's host), both in the background beside (e),
     (f) and (h), each
     adopted by its serving index: recall@10 at least 0.6, and adopt
     refuses after a compaction;
     (h) ``torch_diag_cfg4_misses`` over 11b's plane and index, probe 1024,
     C 320: the misses add up, strict@10 within 1/320 of 11b's; (i)
     ``torch_bench_attention_refold`` at B 256, S 256, best of 2 x 8 steps
     (cut from 3 x 16: an int8 layer takes 130 ms): the folded and int8
     layers within the script's bars of the baseline; (j) ``bash
     scripts/torch_smoke.sh`` (in the background beside (e)-(h)): ``SMOKE
     PASSED``.  The timed parts (a)-(d) and (i) run before the background
     processes start, with nothing else on the card or the host.

Phase 2 also holds both ADC kernels against their plain versions at the
shapes of paths A and B, and times them with the codes in L2, just
rewritten (warm) and flushed from L2 (cold); phases 5 and 6 fail unless
every ADC launch of their path took the vectorised route; phases 7, 9 and 10
fail unless every launch of their parts took the tensor-core or the
vectorised route.  Phase 2 holds the kernels against their plain versions
at phase 9's shapes too (a shard of 2^20 or 2^21 rows, an empty shard, the
half batch of the split encode; 9c adds the 8-bit ADC at a shard's probe),
and at 7f's (the grader's k=3 searches alone, 4 and 16 at once, the
fixture store's RETRIEVAL batch and hybrid queries, ``--beir``'s k=100,
the benchmark service's ingest batches), at 10a's (config 3's 8.8M
rows of 768), and at 11's (the f32 ground truth over a 2^20-row block, an
8-shard scaling shard, the 4-bit ADC at m = 96 for one query over 256 to
4096 blocks and for groups of 2 and 4), and at 12's (the serving buckets
over 2^20 rows, the diagnostic's k=11 scan, the HTTP store's direct and
micro-batched hybrid queries, bge-base's and the trained config's
attention, the adopted snapshot's 8-bit ADC).  The
last two lines are a JSON object listing the kernels and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

N_ROWS = 1 << 20           # flat-index rows (the flat tier's 1M x 384 scan)
N_DOCS = 4096              # documents ingested through the encoder
FILL_BATCH = 1 << 16
# the fill's last write (61,440 rows) reserves a 65,536-row write bucket,
# which takes the power-of-two capacity past 2^20
N_CAPACITY = 1 << 21
SEED = 0
# paths A and B: the ivfpq tier over a clustered corpus (64 near-duplicates
# per cluster, the model of archi_tpu/benchmarking/synth_corpus.py)
PATH_ROWS = 1 << 22
PATH_DOCS = 1024
XL_BLOCK_ROWS = 1 << 17
# phase 7, the service layer
SVC_CLIENTS = 64           # concurrent clients (7a, 7b, 7c)
SVC_CALLS = 8              # store calls a client
HOT_DOCS = 1024            # documents ingested into the hot tail (7b)
XL_ROWS = 1 << 20          # clustered rows of the XL store (7c)
XL_DOCS = 4096             # documents in its exact tail
RERANK_QUERIES = 8
RERANK_TOP = 50
# 7d: local files of about 4 KB in the corpus (cut from 16,384: 7d alone
# took 502 s of the run at that size; from 8,192, whose host-bound ingest
# took 97-230 s)
SVC_FILES = 4096
# 7d's flat index, at which phase 2 holds fused_topk: the corpus's chunks
# in a capacity of 2^15 rows
SVC_ROWS = 20_425
SVC_CAPACITY = 1 << 15
SVC_UPLOADS = 16           # 7d: documents uploaded over HTTP
CHAT_CLIENTS = 32          # 7e: concurrent chat clients
CHAT_CALLS = 4             # 7e: chats a client
CHAT_RERANK = 8            # 7e: in-process chats with the MaxSim rerank
CHAT_OVERFETCH = 20        # 7e: the rerank's pool
ENTRY_GRADES = 16          # 7f: submissions graded at once
ENTRY_QUESTIONS = 16       # 7f: questions a bot answers in one step
ENTRY_TICKETS = 8          # 7f: tickets the Redmine processor drafts
# 7f: the fixture corpus's 1,000-character chunks in the benchmark's and
# evaluate's stores, and their capacity (the index's smallest)
EVAL_ROWS = 490
EVAL_CAPACITY = 4096
BEIR_TOPICS = 30           # 7f: evaluate --beir over write_fixture_beir
BEIR_DOCS_PER_TOPIC = 8
CREATE_FILES = 256         # 7f: 7d's files in the deployment of create
# phase 8, the trainer: MiniLM-L6's widths, phase 3's first documents
TRAIN_HIDDEN = 384
TRAIN_LAYERS = 6
TRAIN_HEADS = 12
TRAIN_DOCS = 1024
TRAIN_VOCAB = 8192
TRAIN_BATCH = 64
TRAIN_SEQ = 96
TRAIN_STEPS = 100
TRAIN_PROBES = 64
# phase 9, the multi-device tier: logical shards on the one card
SHARDS = 4
SHARD_ROWS = 1 << 22       # 9a: 3 GiB of bf16 rows in each of two indexes
SHARD_BLOCK = 3 << 16      # 196,608-row adds: blocks cross the shard seams
SHARD_GROW = 1 << 16       # rows added past the capacity (growth)
SHARD_DOCS = 1024          # 9d's tail documents; 9e's encoded documents
# phase 10, BASELINE configs 3 and 5 and the sweeps
CFG3_ROWS = 8_802_304      # 10a: config 3's 8.8M rows of 768, tile-rounded
STREAM_SECONDS = 20        # 10b, 10c: cut from the JAX scripts' 45 s
CFG5_CAP = 1 << 23         # 10b: config 5's capacity and its live rows
CFG5_LIVE = CFG5_CAP - CFG5_CAP // 64 + 10 * 1024    # after 10 batches
SWEEP_NLIST = 2048         # 10d: the IVF sweep over PATH_ROWS rows
SWEEP_NPROBES = (4, 16, 64, 256, 2048)
PQ_SWEEP_ROWS = 1 << 18    # 10d: the PQ sweeps
SYNTH_BLOCK_ROWS = 1 << 20  # 10e: a block of synth_corpus
# phase 11, BASELINE config 4 on one card: 8 generator blocks of 2^20 rows
# (2^23 rows, a 6.4 GB plane; the JAX script's --quick), cut from config
# 4's 96 for the time limit: 16 blocks took phase 11 to 320 s and the
# whole run to 1,229 s on one host
CFG4_BLOCKS = 8
CFG4_BLOCK_ROWS = 1 << 20  # synth_corpus.BLOCK_ROWS
CFG4_NLIST = 16384         # the JAX r05 build's (16384 // 4 a shard in 11c)
# 11b's host-rerank sweep (npb:C): 11c's total probe budgets, 1024 to 4096
# blocks (4096 is 17% of the 2^23 rows' blocks), at 11c's total C = 320,
# and 4096 at C = 640
CFG4_RERANK = "1024:320,2048:320,4096:320,4096:640"
CFG4_SHARDS = 4            # 11c: logical shards over the plane
CFG4_BUDGETS = (1024, 2048, 4096)   # 11c: total probe budgets
SCALING_ROWS = 1 << 20     # 11d: fixed total rows of the shard scaling
# phase 12, the ported scripts on the card, cut for the time limit
SERVE_CLIENTS = 64         # 12a: cut from 256 clients x 40 requests
SERVE_PER_CLIENT = 8
SERVE_BATCHES = (32, 128, 256)
SERVE_SAMPLE = 64          # 12a: answers held against a direct top-k
HTTP_CHUNKS = 4096         # 12b: cut from 10,000 (its host ingest 8 s)
HTTP_CAPACITY = 8192       # 12b: the hash store's capacity at HTTP_CHUNKS
HTTP_CLIENTS = 64          # 12b: cut from 256 clients x 20 requests
HTTP_PER_CLIENT = 4
HTTP_SAMPLE = 32
INGEST_N = 16_384          # 12c: cut from 100,000 chunks
INGEST_CAPACITY = 32_768   # 12c: the index after its last write bucket
INGEST_BATCH = 2048
ENC_BATCH, ENC_SEQ, ENC_STEPS = 256, 256, 8          # 12d
ENC_MODELS = ("minilm", "bge-base")
QUALITY_STEPS = 100        # 12e: cut from 1,500 training steps
EXP_STEPS = 50             # 12f: cut from 1,500
ANN_ROWS = 1 << 18         # 12g: the corpus the card's build takes
ANN_CPU_ROWS = 1 << 15     # 12g: the CPU build's, cut from 2^18 (325 s)
ANN_NLIST = 1024
#: 12g: (G, S) of the 8-bit ADC at its snapshots (m 48, 64 cells probed of
#: one to four blocks of 512; groups of up to 4 queries within 131,072
#: candidates, one query for the warm-up), held in phase 2
ANN_ADC_SHAPES = ((1, 32768), (4, 131072), (1, 65536), (2, 131072),
                  (1, 98304), (1, 131072))
DIAG_PROBE, DIAG_RERANK = 1024, 320                  # 12h
REFOLD_B, REFOLD_S = 256, 256                        # 12i
REFOLD_STEPS, REFOLD_TRIALS = 8, 2   # 12i: cut from 16 x 3 (int8 130 ms)
#: where the service phase runs: the card (the CPU only in a rehearsal of
#: the phase at small sizes)
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
SERVICE_TMP = os.path.join(ROOT, ".chip_tmp", "service")
TRAIN_TMP = os.path.join(ROOT, ".chip_tmp", "train")
SHARD_TMP = os.path.join(ROOT, ".chip_tmp", "shards")
CFG4_TMP = os.path.join(ROOT, ".chip_tmp", "config4")
SCRIPTS_TMP = os.path.join(ROOT, ".chip_tmp", "scripts")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def check_native_routes(part: str, routes: dict) -> None:
    """Every text of the part (all ASCII) went through the native analyzer
    and WordPiece encoder, and at least one did."""
    check(routes["analyze:python"] == 0 and routes["encode:python"] == 0,
          f"{part}: ASCII texts took the Python route {routes}")
    check(routes["analyze:native"] > 0 or routes["encode:native"] > 0,
          f"{part}: the native library served nothing {routes}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, calls: int = 1) -> float:
    """Device time of one fn() in ms without the host's launch overhead: fn
    captured `calls` times in a CUDA graph (several, where one call is
    shorter than the host's replay of a graph), replayed `iters` times
    between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / calls


def kernel_resources(ptxas_log: str) -> dict[str, str]:
    """Registers, spills and static shared memory of each kernel, from the
    ``-Xptxas -v`` output of one source (names cut to kernel and template
    arguments)."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = re.search(r"([a-z][a-z_]*_kernel)((?:I.*?E)(?=EEv))?",
                             mangled)
            name = (base.group(1) + (base.group(2) or "")) if base else mangled
        elif name and "spill stores" in line:
            out[name] = line.strip()
        elif name and "Used " in line:
            out[name] = (out.get(name, "") + "; "
                         + line.split("ptxas info    : ")[-1]).strip("; ")
    return out


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
def topk_case(name, b, n_pad, n_active, dtype, per_query, k=10, d=384,
              timed=False):
    """Kernel vs plain top-k on one input; returns a result dict.  A corpus
    whose f32 draw passes 4 GiB is drawn 2^20 rows at a time (a whole f32
    draw would not fit beside it at config 3's shape)."""
    import torch

    from archi_tpu_torch.ops.topk import (NEG_INF, _scores, fused_topk,
                                          plain_topk, quantize_int8)

    g = torch.Generator(device="cuda").manual_seed(SEED + b)
    dev = torch.device("cuda")
    q = torch.nn.functional.normalize(
        torch.randn(b, d, device=dev, generator=g), dim=1)

    def draw(rows):
        x = torch.nn.functional.normalize(
            torch.randn(rows, d, device=dev, generator=g), dim=1)
        return quantize_int8(x) if dtype == torch.int8 else x.to(dtype)

    if n_pad * d * 4 > 1 << 32:
        e = torch.empty(n_pad, d, dtype=dtype, device=dev)
        for s0 in range(0, n_pad, 1 << 20):
            e[s0:s0 + (1 << 20)] = draw(min(1 << 20, n_pad - s0))
    else:
        e = draw(n_pad)
    alive = torch.rand(n_pad, device=dev, generator=g) > 0.01
    bias = torch.where(alive, 0.0, NEG_INF)
    if per_query:
        bias = bias[None, :] + 0.3 * torch.rand(b, n_pad, device=dev,
                                                generator=g)
    vals, idx = fused_topk(q, e, bias, n_active, k=k)
    ref_vals, ref_idx = plain_topk(q, e, bias, n_active, k=k)
    torch.cuda.synchronize()
    check(vals.shape == (b, k) and bool(torch.isfinite(vals).all()),
          f"{name}: bad top-k values")
    err = float((vals - ref_vals).abs().max())
    col = torch.arange(n_pad, device=dev)
    scores = torch.where(col < n_active, _scores(q, e) + bias, NEG_INF)
    claimed = torch.gather(scores, 1, idx.long())
    row_err = float((claimed - vals).abs().max())
    del scores, claimed
    distinct = all(len(set(r)) == k for r in idx.cpu().tolist())
    if dtype == torch.int8:
        tol = 0.0   # integer products summed exactly: identical results
        check(torch.equal(idx, ref_idx), f"{name}: rows differ from plain")
    else:
        tol = 1e-4  # f32 sums in another order than the plain matmul
    check(err <= tol and row_err <= tol and distinct,
          f"{name}: max_abs_err {err:.3g} row_err {row_err:.3g} "
          f"distinct {distinct} (tol {tol})")
    res = {"case": name, "B": b, "n_pad": n_pad, "n_active": n_active,
           "dtype": str(dtype).replace("torch.", ""), "per_query_bias":
           per_query, "k": k, "max_abs_err": err, "tol": tol}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol}) ok")
    if timed:
        # device time of one call from a CUDA graph, and CUDA events over
        # the wrapper called 10 times
        res["ms"] = graph_ms(lambda: fused_topk(q, e, bias, n_active, k=k))
        res["ms_events"] = cuda_ms(lambda: fused_topk(q, e, bias, n_active,
                                                      k=k))
        res["plain_ms"] = cuda_ms(
            lambda: plain_topk(q, e, bias, n_active, k=k), iters=3, warmup=1)
        # the same function over the live rows (n_active >= k here)
        e_live, bias_live = e[:n_active], bias[..., :n_active]
        if dtype == torch.int8:
            # int8 x int8 -> int32 (cuBLASLt), scaled as the kernel scales
            q8 = quantize_int8(q)

            def library():
                s = (torch._int_mm(q8, e_live.T).float()
                     * (1.0 / (127.0 * 127.0)) + bias_live)
                return torch.topk(s, k, dim=1)
        else:
            def library():
                s = (q.to(dtype) @ e_live.T).float() + bias_live
                return torch.topk(s, k, dim=1)
        try:
            lib_vals = library().values
            res["library_max_abs_err"] = float((lib_vals - ref_vals).abs().max())
            res["library_ms"] = graph_ms(library)
            res["library_ms_events"] = cuda_ms(library)
        except RuntimeError as exc:     # the library refuses this shape
            res["library_ms"] = None
            res["library_refused"] = str(exc).splitlines()[0]
        # the function reads the live rows of E and of the bias only
        itemsize = e.element_size()
        bias_rows = b if per_query else 1
        nbytes = (n_active * d * itemsize + b * d * 4
                  + bias_rows * n_active * 4 + b * k * 8)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 2.0 * b * n_active * d, res["dtype"])
        log(f"    ms {res['ms']:.4f} (events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']} "
            f"{res.get('library_refused', '')}bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


def attention_case(name, b, s, dtype, nh=12, hd=32, timed=False):
    import torch
    import torch.nn.functional as F

    from archi_tpu_torch.ops.attention import (encoder_attention,
                                               p_rounding_bound,
                                               plain_attention)

    g = torch.Generator(device="cuda").manual_seed(SEED + s)
    dev = torch.device("cuda")
    h = nh * hd
    qkv = torch.randn(b, s, 3 * h, device=dev, generator=g).to(dtype)
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd) for i in range(3))
    lens = torch.randint(1, s + 1, (b,), device=dev, generator=g)
    if b > 1:
        lens[0] = 0                               # a fully masked row
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).float()
    key_bias = (1.0 - mask) * -1e9
    scale = 1.0 / math.sqrt(hd)
    out = encoder_attention(q, k, v, key_bias, sm_scale=scale)
    ref = plain_attention(q, k, v, key_bias, sm_scale=scale)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    res = {"case": name, "B": b, "S": s, "nh": nh, "hd": hd,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err}
    if dtype == torch.float32:
        tol_desc, ok = "2e-5", err <= 2e-5
    else:
        # one bf16 step of the output, plus one bf16 step of each rounded
        # probability: both round p to bf16, from logits summed in another
        # order (ops/attention.py: p_rounding_bound)
        tol_desc = "2^-7*|ref| + 1e-3 + p_rounding_bound"
        flips = p_rounding_bound(q, k, v, key_bias, sm_scale=scale)
        step = ref.float().abs() * 2.0 ** -7 + 1e-3
        ok = bool((diff <= step + flips).all())
        # the share of outputs outside one bf16 step of the output alone
        res["beyond_one_step"] = float((diff > step).float().mean())
        del flips, step
    res["tol"] = tol_desc
    check(ok, f"{name}: max_abs_err {err:.3g} (tol {tol_desc})")
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol_desc}) ok")
    if timed:
        # device time of one call from a CUDA graph (the small query
        # buckets are as short as the wrapper's host work), and CUDA events
        # over the wrapper called 10 times
        res["ms"] = graph_ms(
            lambda: encoder_attention(q, k, v, key_bias, sm_scale=scale))
        res["ms_events"] = cuda_ms(
            lambda: encoder_attention(q, k, v, key_bias, sm_scale=scale))
        res["plain_ms"] = cuda_ms(
            lambda: plain_attention(q, k, v, key_bias, sm_scale=scale),
            iters=3, warmup=1)
        mask_t = key_bias.to(dtype)[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask_t, scale=scale)
        res["library_ms"] = graph_ms(library)
        res["library_ms_events"] = cuda_ms(library)
        itemsize = q.element_size()
        nbytes = 4 * b * s * h * itemsize + b * s * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 4.0 * b * nh * s * s * hd, res["dtype"])
        log(f"    ms {res['ms']:.4f} (events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']:.4f} (events "
            f"{res['library_ms_events']:.4f}) bound {res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    return res


def adc_case(name, m, g, s, packed, timed=False, ksub=256):
    """ADC kernel vs its plain version on one random input; returns a
    result dict.  The yardstick is ``F.embedding_bag`` over the
    bf16-rounded table (nibbles unpacked beforehand for 4-bit codes)."""
    import torch
    import torch.nn.functional as F

    from archi_tpu_torch.ops import ROUTE_LAUNCHES, adc

    dev = torch.device("cuda")
    g_ = torch.Generator(device="cuda").manual_seed(SEED + m + g + s)
    ksub = 16 if packed else ksub
    luts = torch.randn(m, g, ksub, device=dev, generator=g_)
    codes = torch.randint(0, ksub, (m, s), device=dev, generator=g_,
                          dtype=torch.uint8)
    if packed:
        codes_in = adc.pack_nibbles(codes.t()).t().contiguous()
        kernel, plain = adc.adc_scores_lut16, adc.plain_adc_scores_lut16
    else:
        codes_in, kernel, plain = codes, adc.adc_scores, adc.plain_adc_scores
    wrapper = "adc_scores_lut16" if packed else "adc_scores"
    before = dict(ROUTE_LAUNCHES)
    out = kernel(luts, codes_in)
    ref = plain(luts, codes_in)
    torch.cuda.synchronize()
    route = [k.split(":")[1] for k in ROUTE_LAUNCHES
             if k.startswith(wrapper + ":") and ROUTE_LAUNCHES[k] > before[k]]
    err = float((out - ref).abs().max())
    tol = 1e-5   # both sum the bf16 table in subspace order (0 expected)
    check(out.shape == (g, s) and bool(torch.isfinite(out).all())
          and err <= tol, f"{name}: max_abs_err {err:.3g} (tol {tol})")
    res = {"case": name, "m": m, "G": g, "S": s, "ksub": ksub,
           "packed": packed, "route": route[0], "max_abs_err": err,
           "tol": tol}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol}) ok, {route[0]} route")
    if timed:
        # device times from CUDA graphs of ten calls (a call is shorter than
        # the host's replay of a graph): replayed as they are (the codes stay
        # in L2); warm, each call after a copy that rewrites the codes, as
        # the candidate gather leaves them for the caller; cold, each call
        # after a 64 MB write that flushes the 50 MB L2.  The copy's and the
        # write's own graphs are timed and taken off.
        def call():
            return kernel(luts, codes_in)

        src = codes_in.clone()
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        res["ms"] = graph_ms(call, calls=10)
        res["ms_warm"] = (graph_ms(lambda: (codes_in.copy_(src), call()), calls=10)
                          - graph_ms(lambda: codes_in.copy_(src), calls=10))
        res["ms_cold"] = (graph_ms(lambda: (flush.zero_(), call()), calls=10)
                          - graph_ms(lambda: flush.zero_(), calls=10))
        del flush, src
        res["ms_events"] = cuda_ms(call)
        res["plain_ms"] = graph_ms(lambda: plain(luts, codes_in), iters=3)
        table = adc.round_lut(luts).permute(0, 2, 1).reshape(
            m * ksub, g).contiguous()
        bags = (codes.t().long()
                + ksub * torch.arange(m, device=dev)).contiguous()
        lib_err = float((F.embedding_bag(bags, table, mode="sum").t()
                         - ref).abs().max())
        res["library_ms"] = graph_ms(
            lambda: F.embedding_bag(bags, table, mode="sum"))
        res["library_max_abs_err"] = lib_err
        nbytes = codes_in.numel() + luts.numel() * 4 + g * s * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, m * g * s,
                                                 "float32")
        log(f"    ms {res['ms']:.4f} (warm {res['ms_warm']:.4f}, cold "
            f"{res['ms_cold']:.4f}, events {res['ms_events']:.4f}) plain "
            f"{res['plain_ms']:.4f} library "
            f"{res['library_ms']:.4f} (err {lib_err:.3g}) bound "
            f"{res['bound_ms']:.4f} ({res['bound_by']})")
    return res


# ------------------------------------------------------------------ phase 3
def synthetic_texts(rng, vocab, n, n_words, prefix=None):
    import numpy as np

    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    picks = rng.choice(len(vocab), size=(n, n_words), p=p)
    texts = [" ".join(vocab[j] for j in row) for row in picks]
    if prefix is not None:
        texts = [f"{prefix}{i:05d} {t}" for i, t in enumerate(texts)]
    return texts


def ids_of(results):
    return [d.metadata["chunk_id"] for d, _ in results]


def same_ranking(got, want, tol=1e-4):
    """Tie-aware: equal length, scores within tol, and any id mismatch sits
    between scores equal within tol."""
    if len(got) != len(want):
        return False
    for (gd, gs), (wd, ws) in zip(got, want):
        if abs(gs - ws) > tol:
            return False
    gs_by_id = {d.metadata["chunk_id"]: s for d, s in got}
    ws_by_id = {d.metadata["chunk_id"]: s for d, s in want}
    cut = min(s for _d, s in want) if want else 0.0
    for cid in set(gs_by_id) ^ set(ws_by_id):
        s = gs_by_id.get(cid, ws_by_id.get(cid))
        if abs(s - cut) > tol:
            return False
    return True


def brute_force_hybrid(store, queries, k, w_sem=0.7, w_b=0.3):
    """The batched hybrid ranking recomputed with the plain top-k over the
    store's own tensors (no kernel)."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.flat_index import l2_normalize
    from archi_tpu_torch.engine.topk import alive_to_bias
    from archi_tpu_torch.ops.topk import plain_topk

    index = store.index
    cap = index.capacity
    bm = torch.stack([store.bm25.scores(q, cap) for q in queries])
    embs = torch.from_numpy(store._embed_queries(queries)).to(DEV)
    if hasattr(index, "main"):
        # hot tail: main's merged rows, then the tail, by global row
        nm = index.n_merged
        emb = torch.cat([index.main.emb[:nm], index.tail.emb])
        n_rows = nm + index.tail.n_rows
    else:
        emb, n_rows = index.emb, index.n_rows
    n = emb.shape[0]
    bias = alive_to_bias(index.alive[:n])[None, :] + bm[:, :n] * (w_b / w_sem)
    vals, rows = plain_topk(l2_normalize(embs), emb, bias, n_rows, k=k)
    bm_max = bm.max(dim=1).values.cpu().numpy()
    out = []
    for b in range(len(queries)):
        res = store._rows_to_results(rows[b].cpu().numpy(),
                                     vals[b].cpu().numpy())
        scale = 1.0 if bm_max[b] <= 0.0 else w_sem
        out.append([(d, s * scale) for d, s in res])
    return out


def main_path(results: dict):
    """Phase 3: the port's main path at MiniLM-L6 width.  Returns the
    launch counts of that run, the store, the embedder, the hybrid query
    batch and the ingested documents."""
    import numpy as np
    import torch

    from archi_tpu_torch import native
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 9)))
             for _ in range(5000)]
    # ~100-word chunks: about 100 tokens, the encoder's 128 bucket
    docs = synthetic_texts(rng, vocab, N_DOCS, 96, prefix="doc")
    fill_texts = synthetic_texts(rng, vocab, N_ROWS - N_DOCS, 5)

    t0 = time.perf_counter()
    # no vocab.txt is in the repository: a word-level WordPiece vocab of
    # the corpus, at MiniLM's vocabulary size
    tok = WordPieceTokenizer.build_vocab(docs, size=30522)
    emb = TorchEmbedder(config=BertConfig.minilm_l6(), tokenizer=tok,
                        seed=SEED)
    store = TorchVectorStore(emb)
    log(f"  MiniLM-L6 embedder + store built in "
        f"{time.perf_counter() - t0:.1f} s (bf16, random weights, seed {SEED})")

    # ---- the main path, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    doc_ids = store.add_texts(
        docs, metadatas=[{"resource_hash": f"r{i % 64}",
                          "kind": "even" if i % 2 == 0 else "odd"}
                         for i in range(N_DOCS)])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    log(f"  ingested {N_DOCS} documents through the encoder in "
        f"{t_ingest:.2f} s ({N_DOCS / t_ingest:.0f} docs/s, tokenizer "
        f"included)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.perf_counter()
    for s0 in range(0, len(fill_texts), FILL_BATCH):
        chunk = fill_texts[s0:s0 + FILL_BATCH]
        store.add_texts(chunk, embeddings=torch.randn(
            len(chunk), emb.dim, device="cuda", generator=g))
    torch.cuda.synchronize()
    log(f"  filled the index to {store.count()} rows in "
        f"{time.perf_counter() - t0:.1f} s (capacity {store.index.capacity})")
    check(store.count() == N_ROWS and store.index.capacity == N_CAPACITY,
          "index fill (rows, capacity)")

    probes = list(range(0, N_DOCS, N_DOCS // 8))
    t0 = time.perf_counter()
    for i in probes:
        top = store.similarity_search_with_score(docs[i], k=5)
        check(ids_of(top)[0] == doc_ids[i],
              f"semantic: doc {i} does not retrieve itself at rank 1")
        top = store.hybrid_search(docs[i], k=5)
        check(ids_of(top)[0] == doc_ids[i],
              f"hybrid: doc {i} does not retrieve itself at rank 1")
    log(f"  {len(probes)} documents retrieve themselves at rank 1 "
        f"(semantic and hybrid) in {time.perf_counter() - t0:.2f} s")
    hybrid_q = ([docs[i] for i in range(0, N_DOCS, N_DOCS // 24)][:24]
                + [" ".join(vocab[j] for j in (3, 17)), vocab[40],
                   "zzzzqx unmatched query", vocab[1] + " " + vocab[900]]
                + [docs[7][:40], docs[8][:30], docs[9][-30:], vocab[123]])
    check(len(hybrid_q) == 32, "hybrid batch size")
    hybrid = store.hybrid_search_batch(hybrid_q, k=10)
    filtered = store.hybrid_search_batch(hybrid_q[:8], k=10,
                                         filter={"kind": "even"})
    semantic32 = store.similarity_search_batch(hybrid_q, k=10)
    semantic256 = store.similarity_search_batch(
        [docs[i] for i in range(256)], k=10)
    torch.cuda.synchronize()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    fallbacks = engine_topk.FUSED_FALLBACKS["count"]
    log(f"  main-path launches {launches}, routes {routes}, top-k fallbacks "
        f"{fallbacks}")
    check(launches["fused_topk"] > 0, "fused_topk never launched")
    check(launches["encoder_attention"] > 0,
          "encoder_attention never launched")
    # the index and the encoder are bf16: every launch on the tensor cores
    for name in ("fused_topk", "encoder_attention"):
        check(routes[f"{name}:tensor_core"] == launches[name],
              f"{name}: launches off the tensor-core route {routes}")
    results["routes"] = {"main": routes}
    check(fallbacks == 0, "the top-k fell back to the plain version")
    text_routes = dict(native.ROUTES)
    log(f"  text analysis routes {text_routes}")
    check_native_routes("main path", text_routes)
    results["text_routes"] = {"main": text_routes}

    # ---- checks against a brute-force scan of the same tensors
    check(all(len(r) == 10 for r in hybrid + semantic32 + semantic256),
          "short result lists")
    check(all(d.metadata["kind"] == "even" for r in filtered for d, _ in r),
          "filter leaked rows")
    check(all(ids_of(semantic256[i])[0] == doc_ids[i] for i in range(256)),
          "batched semantic: a document misses itself at rank 1")
    brute = brute_force_hybrid(store, hybrid_q, 10)
    bad = [i for i, (g_, w_) in enumerate(zip(hybrid, brute))
           if not same_ranking(g_, w_)]
    check(not bad, f"hybrid batch differs from brute force at {bad}")
    fallback_row = hybrid_q.index("zzzzqx unmatched query")
    check(same_ranking(hybrid[fallback_row], store.similarity_search_with_score(
        hybrid_q[fallback_row], k=10)), "BM25-empty query did not fall back")
    log("  hybrid batch (B=32, per-query bias) matches the brute-force scan; "
        "filter, fallback and self-retrieval hold")

    # ---- encoder output against the same weights on the CPU
    cpu = TorchEmbedder(config=BertConfig.minilm_l6(), tokenizer=tok,
                        seed=SEED, device="cpu")
    small = docs[:8]
    a, b = emb.encode_numpy(small), cpu.encode_numpy(small)
    cos = float(np.min(np.sum(a * b, axis=1)))
    # runs on an H100 measure 0.999997 (bf16 rounding); the limit allows
    # about 30 times that gap from 1
    check(np.isfinite(a).all() and a.shape == (8, 384) and cos >= 0.9999,
          f"encoder on the card vs CPU f32: min cosine {cos:.5f}")
    log(f"  encoder bf16 on the card vs f32 on the CPU: min cosine {cos:.5f}")
    results["e2e"] = {"ingest_docs_per_s": N_DOCS / t_ingest,
                      "encoder_cosine_vs_cpu_f32": cos}
    return launches, store, emb, hybrid_q, docs, vocab


def timings(results, store, emb, hybrid_q, docs):
    """Phase 4: encoder and query times on the card, and where the time of
    a batched hybrid search and of ingest goes (ingest on both routes of
    the text analysis)."""
    import numpy as np
    import torch

    from archi_tpu_torch import native
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.bert import encode

    rng = np.random.default_rng(SEED + 2)
    ids = torch.from_numpy(rng.integers(1000, 30000, (256, 128))).cuda()
    mask = torch.ones(256, 128, dtype=torch.long, device="cuda")
    ms = cuda_ms(lambda: encode(emb.model, ids, mask), iters=10)
    e2e = results["e2e"]
    e2e["encoder_ms_b256_s128"] = ms
    e2e["encoder_chunks_per_s_b256_s128"] = 256 / ms * 1e3
    for b in (32, 256):
        q = torch.randn(b, 384, device="cuda")
        ms = cuda_ms(lambda: store.index.search_dispatch(q, k=10), iters=10)
        e2e[f"search_ms_b{b}"] = ms
        e2e[f"search_qps_b{b}"] = b / ms * 1e3
    store.hybrid_search_batch(hybrid_q, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        store.hybrid_search_batch(hybrid_q, k=10)
    torch.cuda.synchronize()
    t = (time.perf_counter() - t0) / reps
    e2e["hybrid_batch32_s"] = t
    e2e["hybrid_qps_b32"] = 32 / t
    t0 = time.perf_counter()
    for q in hybrid_q[:8]:
        store.hybrid_search(q, k=10)
    e2e["hybrid_single_ms"] = (time.perf_counter() - t0) / 8 * 1e3
    log("  " + json.dumps(e2e))

    # where the time of the two store calls goes (host clock, synchronised)
    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    w = 0.3 / 0.7
    bm, t_bm25 = stage(lambda: torch.stack(
        [store.bm25.scores(q, store.index.capacity) for q in hybrid_q]))
    embs, t_embed = stage(lambda: store._embed_queries(hybrid_q))
    (_, vals, rows), t_scan = stage(
        lambda: store.index.search(embs, k=10, bias=bm * w))
    _, t_rows = stage(lambda: [store._rows_to_results(rows[b], vals[b])
                               for b in range(len(hybrid_q))])
    results["breakdown"] = {
        "hybrid_batch32_ms": {"bm25_scores": t_bm25 * 1e3,
                              "embed_queries": t_embed * 1e3,
                              "index_search": t_scan * 1e3,
                              "rows_to_results": t_rows * 1e3}}

    # ingest of the same 1024 documents through the native analyzer and
    # WordPiece encoder (the normal route), then through the Python route
    docs = docs[:1024]
    outputs, rates = {}, {}
    for route in ("native", "python"):
        previous = native.use_native(route == "native")
        native.reset_routes()
        try:
            id_lists, t_tok = stage(
                lambda: [emb.tokenizer.encode(t, emb.max_length)
                         for t in docs])
            terms, t_ana = stage(lambda: store.bm25.analyze_batch(docs))
            _, t_ing = stage(lambda: TorchVectorStore(emb).add_texts(docs))
        finally:
            native.use_native(previous)
        routes = dict(native.ROUTES)
        outputs[route] = (id_lists, terms)
        rates[route] = len(docs) / t_ing
        results["breakdown"][f"ingest_1024_docs_ms_{route}"] = {
            "tokenize": t_tok * 1e3, "bm25_analyze": t_ana * 1e3,
            "add_texts": t_ing * 1e3}
        results["text_routes"][f"ingest_{route}"] = routes
        log(f"  ingest of 1024 documents, {route} route: tokenize "
            f"{t_tok * 1e3:.1f} ms, bm25_analyze {t_ana * 1e3:.1f} ms, "
            f"add_texts {t_ing * 1e3:.1f} ms ({rates[route]:.0f} docs/s); "
            f"routes {routes}")
    # each of the two runs makes 2048 calls of each function
    check_native_routes("ingest, native route", results["text_routes"][
        "ingest_native"])
    check(results["text_routes"]["ingest_python"]["analyze:native"] == 0
          and results["text_routes"]["ingest_python"]["encode:native"] == 0,
          "ingest, Python route: the native library served calls")
    check(outputs["native"] == outputs["python"],
          "the native and Python routes give other ids or terms")
    _, t_enc = stage(lambda: emb.encode_ids(outputs["native"][0]))
    results["breakdown"]["ingest_1024_docs_ms_native"]["encode"] = t_enc * 1e3
    e2e["ingest_docs_per_s_1024"] = rates
    log("  breakdown " + json.dumps(results["breakdown"]))


# ------------------------------------------------------------- phases 5-6
class ClusteredRows:
    """The clustered corpus of archi_tpu/benchmarking/synth_corpus.py, made
    on the card from a seed: PATH_ROWS / 64 standard-normal centres, each
    row a random centre + 0.3 sigma noise, renormalised (64 near-duplicates
    per cluster on average)."""

    def __init__(self, n_rows: int, seed: int, d: int = 384):
        import torch

        self.gen = torch.Generator(device=DEV).manual_seed(seed)
        self.centers = torch.randn(n_rows // 64, d, device=DEV,
                                   generator=self.gen)

    def rows(self, n: int, clusters=None):
        import torch

        if clusters is None:
            clusters = torch.randint(0, self.centers.shape[0], (n,),
                                     device=DEV, generator=self.gen)
        v = self.centers[clusters] + 0.3 * torch.randn(
            n, self.centers.shape[1], device=DEV, generator=self.gen)
        return torch.nn.functional.normalize(v, dim=1)


def same_rows(got_v, got_r, want_v, want_r, tol=1e-5):
    """Tie-aware: scores within tol position by position, and a row in one
    list only ties with the last score kept."""
    import numpy as np

    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    if got_v.shape != want_v.shape or np.abs(got_v - want_v).max() > tol:
        return False
    for b in range(got_v.shape[0]):
        g = dict(zip(np.asarray(got_r[b]).tolist(), got_v[b].tolist()))
        w = dict(zip(np.asarray(want_r[b]).tolist(), want_v[b].tolist()))
        if any(abs(g.get(r, w.get(r)) - want_v[b, -1]) > tol
               for r in set(g) ^ set(w)):
            return False
    return True


def recall_at_10(rows, exact_rows) -> float:
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(rows, exact_rows)) / (10 * len(exact_rows))


def exact_scan(emb, n_rows: int, q, k: int = 10, bias=None):
    """Exact top-k of ``q · emb[i] + bias[i]`` over emb[:n_rows] (f32
    products, chunked; ``bias`` an optional [>= n_rows] f32 vector) →
    (vals, rows) as host arrays."""
    import torch

    from archi_tpu_torch.engine.topk import topk_lower_first

    vals, rows = [], []
    for s0 in range(0, n_rows, 1 << 20):
        s1 = min(n_rows, s0 + (1 << 20))
        sc = q @ emb[s0:s1].float().T
        if bias is not None:
            sc = sc + bias[s0:s1][None, :]
        v, p = topk_lower_first(sc, k)
        vals.append(v)
        rows.append(p + s0)
    v, p = topk_lower_first(torch.cat(vals, dim=1), k)
    return (v.cpu().numpy(),
            torch.gather(torch.cat(rows, dim=1), 1, p).cpu().numpy())


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall time of fn() in ms, synchronised, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def path_a(results, emb, docs, vocab):
    """Phase 5: ``type: ivfpq`` serving at the bootstrap's defaults.
    Returns its launch counts, the store, the corpus generator and the
    recall queries."""
    import numpy as np
    import torch

    from archi_tpu_torch import native
    from archi_tpu_torch.bin.bootstrap import build_index
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.ann_index import AnnFlatIndex
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED + 5)
    docs = docs[:PATH_DOCS]
    fill_texts = synthetic_texts(rng, vocab, PATH_ROWS - PATH_DOCS, 3)
    corpus = ClusteredRows(PATH_ROWS, SEED + 6)
    # the bootstrap's `type: ivfpq` arguments, spelled out
    index = build_index(384, {
        "type": "ivfpq", "nlist": 1024, "nprobe": 64, "nprobe_blocks": None,
        "cell_gate": None, "block_rank_sub": 8, "min_snapshot_rows": 1 << 15,
        "pq_m": 48, "pq_refine_m": 48, "extract": "auto", "hier_t": 64,
        "async_refresh": True})
    check(isinstance(index, AnnFlatIndex) and index.snapshot_kind == "ivfpq",
          "build_index did not give an ivfpq AnnFlatIndex")
    store = TorchVectorStore(emb, index=index)
    out = {}

    # ---- the path, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    doc_ids = store.add_texts(
        docs, metadatas=[{"kind": "even" if i % 2 == 0 else "odd"}
                         for i in range(PATH_DOCS)])
    for s0 in range(0, len(fill_texts), FILL_BATCH):
        chunk = fill_texts[s0:s0 + FILL_BATCH]
        store.add_texts(chunk, embeddings=corpus.rows(len(chunk)))
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    out["rows"], out["capacity"] = store.count(), index.capacity
    log(f"  ingested {PATH_DOCS} documents and filled to {store.count()} "
        f"rows in {out['fill_s']:.1f} s (capacity {index.capacity}; text "
        f"routes {native.ROUTES})")
    results["text_routes"]["path_a_fill"] = dict(native.ROUTES)
    check_native_routes("path A fill", native.ROUTES)
    check(store.count() == PATH_ROWS, "path A fill")
    t0 = time.perf_counter()
    index.refresh_ann()
    torch.cuda.synchronize()
    out["snapshot_build_s"] = time.perf_counter() - t0
    ivf = index._ivf
    check(ivf is not None and index._n_snap == PATH_ROWS, "no snapshot")
    out["n_blocks"], out["max_bpc"] = (int(ivf.code_blocks.shape[0]),
                                       int(ivf.cell_blocks.shape[1]))
    out["adc_candidates_per_query"] = 64 * out["max_bpc"] * 512
    log(f"  ivfpq snapshot built in {out['snapshot_build_s']:.1f} s "
        f"({out['n_blocks']} blocks, max {out['max_bpc']} a cell)")

    probes = list(range(0, PATH_DOCS, PATH_DOCS // 16))
    sem_self = sum(ids_of(store.similarity_search_with_score(
        docs[i], k=5))[:1] == [doc_ids[i]] for i in probes)
    hyb_self = sum(ids_of(store.hybrid_search(docs[i], k=5))[:1]
                   == [doc_ids[i]] for i in probes)
    q_docs = [docs[i] for i in range(0, PATH_DOCS, PATH_DOCS // 32)]
    semantic = store.similarity_search_batch(q_docs, k=10)
    hybrid = store.hybrid_search_batch(q_docs, k=10)
    filtered = store.hybrid_search_batch(q_docs[:8], k=10,
                                         filter={"kind": "even"})
    stored = torch.arange(PATH_DOCS, PATH_ROWS, (PATH_ROWS - PATH_DOCS) // 32,
                          device="cuda")[:32]
    _i, _v, stored_top = index.search(index.emb[stored].float(), k=10)
    fresh = corpus.rows(4096)
    store.add_texts(synthetic_texts(rng, vocab, 4096, 3), embeddings=fresh)
    _i, fresh_v, fresh_top = index.search(fresh[::128], k=10)
    torch.cuda.synchronize()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    log(f"  path A launches {launches}, routes {routes}, top-k fallbacks "
        f"{engine_topk.FUSED_FALLBACKS['count']}")
    for name in ("adc_scores", "fused_topk", "encoder_attention"):
        check(launches[name] > 0, f"path A: {name} never launched")
    for name in ("fused_topk", "encoder_attention"):
        check(routes[f"{name}:tensor_core"] == launches[name],
              f"path A: {name} launches off the tensor-core route {routes}")
    # the candidate sets are whole blocks of 512 codes: vectorised loads
    check(routes["adc_scores:vector"] == launches["adc_scores"],
          f"path A: adc_scores launches off the vectorised route {routes}")
    results.setdefault("routes", {})["path_a"] = routes
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "top-k fell back")

    # ---- checks.  Limits from the first card runs (PERF.md): stored
    # rows and documents (hybrid) read 1.0; recall@10 read 0.781 and 0.756,
    # so its limit leaves room for spread between runs (random candidates
    # would read near 0).  Documents through the random-weight encoder
    # lie within about 1e-2 of each other in cosine, under the PQ error, so
    # semantic self-retrieval of documents is a reading, not a check
    # (0.0625 in both runs).
    out["self_rank1_docs_semantic"] = sem_self / len(probes)
    out["self_rank1_docs_hybrid"] = hyb_self / len(probes)
    out["self_rank1_stored_rows"] = float(np.mean(
        stored_top[:, 0] == stored.cpu().numpy()))
    pe = emb.encode_numpy([docs[i] for i in probes])
    cos = pe @ pe.T
    out["probe_docs_mean_cosine"] = float(
        (cos.sum() - np.trace(cos)) / (len(probes) * (len(probes) - 1)))
    check(out["self_rank1_docs_hybrid"] >= 0.9
          and out["self_rank1_stored_rows"] >= 0.9,
          f"path A self-retrieval: {out}")
    check(all(len(r) == 10 for r in semantic + hybrid), "short results")
    check(all(d.metadata["kind"] == "even" for r in filtered for d, _ in r),
          "filter leaked rows")
    fresh_rows = np.arange(PATH_ROWS, PATH_ROWS + 4096, 128)
    check(bool((fresh_top[:, 0] == fresh_rows).all())
          and bool((fresh_v[:, 0] > 0.99).all()),
          "fresh rows not found through the tail")
    # the same B=32 batches (now over the fresh rows too) with the kernel
    # and with the plain ADC
    with_kernel = (store.similarity_search_batch(q_docs, k=10)
                   + store.hybrid_search_batch(q_docs, k=10))
    index.adc_impl = "plain"
    with_plain = (store.similarity_search_batch(q_docs, k=10)
                  + store.hybrid_search_batch(q_docs, k=10))
    index.adc_impl = None
    bad = [i for i, (a, b) in enumerate(zip(with_kernel, with_plain))
           if not same_ranking(a, b, tol=1e-5)]
    check(not bad, f"kernel and plain ADC differ at {bad}")
    queries = corpus.rows(32)
    _i, _v, ann_rows = index.search(queries, k=10)
    exact = exact_scan(index.emb, index.n_rows, queries)[1]
    out["recall_at_10"] = recall_at_10(ann_rows, exact)
    check(out["recall_at_10"] >= 0.6,
          f"path A recall@10 {out['recall_at_10']:.3f} < 0.6")
    log(f"  probe documents' mean cosine {out['probe_docs_mean_cosine']:.4f}")
    log(f"  self rank-1: docs semantic {out['self_rank1_docs_semantic']:.3f} "
        f"hybrid {out['self_rank1_docs_hybrid']:.3f}, stored rows "
        f"{out['self_rank1_stored_rows']:.3f}; recall@10 "
        f"{out['recall_at_10']:.3f}; kernel == plain ADC on B=32 semantic "
        f"and hybrid; filter and fresh tail hold")

    # ---- save/load round trip of the snapshot sidecar
    tmp = os.path.join(ROOT, ".chip_tmp", "path_a")
    os.makedirs(tmp, exist_ok=True)
    try:
        before = index.search(queries, k=10)
        t0 = time.perf_counter()
        path = os.path.join(tmp, "index.npz")
        ivf.save(path + ".ann.npz")
        with open(path + ".ann.json", "w") as f:
            json.dump({"n_snap": PATH_ROWS, "kind": "ivfpq"}, f)
        check(index.adopt_snapshot(path, warm=False), "snapshot not adopted")
        after = index.search(queries, k=10)
        out["snapshot_save_load_s"] = time.perf_counter() - t0
        check(index._ivf is not ivf and same_rows(after[1], after[2],
                                                  before[1], before[2], 0.0),
              "save/load round trip changed the results")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  snapshot save/load round trip in "
        f"{out['snapshot_save_load_s']:.1f} s returns the same results")

    # ---- times (host clock, synchronised)
    q_emb = torch.from_numpy(store._embed_queries(q_docs)).cuda()
    out["semantic_index_ms_b32"] = host_ms(lambda: index.search(q_emb, k=10))
    out["semantic_store_ms_b32"] = host_ms(
        lambda: store.similarity_search_batch(q_docs, k=10))
    out["hybrid_store_ms_b32"] = host_ms(
        lambda: store.hybrid_search_batch(q_docs, k=10))
    for key in ("semantic_index", "semantic_store", "hybrid_store"):
        out[f"{key}_qps_b32"] = 32 / out[f"{key}_ms_b32"] * 1e3
    row_bias = torch.zeros(index.capacity, device="cuda")
    out["ann_dispatch_ms_b32"] = host_ms(lambda: index._ivf.search_dispatch(
        q_emb, k=40, nprobe=64, bias=row_bias, normalize_queries=False,
        refine_overfetch=1))
    log("  " + json.dumps(out))
    results["path_a"] = out
    return launches, store, corpus, queries, exact


def path_b(results, index_a, corpus):
    """Phase 6: the XL tier's snapshot over path A's first PATH_ROWS rows
    (engine/xl_index.py's build and search arguments)."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.host_store import HostVectorStore, exact_rerank
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    emb = index_a.emb
    n_blocks = PATH_ROWS // XL_BLOCK_ROWS
    out = {}
    t0 = time.perf_counter()
    host = HostVectorStore(384, capacity=PATH_ROWS)
    for i in range(n_blocks):
        host.add(emb[i * XL_BLOCK_ROWS:(i + 1) * XL_BLOCK_ROWS]
                 .half().cpu().numpy())
    out["host_store_fill_s"] = time.perf_counter() - t0

    def block_fn(i):
        return emb[i * XL_BLOCK_ROWS:(i + 1) * XL_BLOCK_ROWS].float()

    queries = corpus.rows(32)
    q_np = queries.cpu().numpy()
    bias = torch.zeros(PATH_ROWS, device="cuda")

    def search(adc_impl=None):
        vals, rows = ivf.search_dispatch(
            queries, k=160, nprobe_blocks=128, cell_gate=None, bias=bias,
            normalize_queries=False, refine_overfetch=1, extract="auto",
            hier_t=64, adc_impl=adc_impl)
        return vals.cpu().numpy(), rows.cpu().numpy()

    reset_launches()
    t0 = time.perf_counter()
    ivf = IVFPQIndex.build_streaming(
        block_fn, n_blocks, XL_BLOCK_ROWS, nlist=4096, block=512, m=48,
        ksub=16, refine_m=48, train_blocks=2, spill_frac=0.0, opq_iters=0)
    ivf.ensure_block_centroids(dtype=torch.bfloat16, sub=8)
    torch.cuda.synchronize()
    out["snapshot_build_s"] = time.perf_counter() - t0
    out["n_blocks"] = int(ivf.code_blocks.shape[0])
    check(ivf.packed and ivf.code_blocks.shape[2] == 24, "codes not packed")
    cand_v, cand_r = search()
    vals, rows = exact_rerank(host, q_np, cand_v, cand_r, k=10)
    torch.cuda.synchronize()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    log(f"  XL snapshot built in {out['snapshot_build_s']:.1f} s "
        f"({out['n_blocks']} blocks); launches {launches}, routes {routes}")
    check(launches["adc_scores_lut16"] > 0,
          "path B: adc_scores_lut16 never launched")
    check(routes["adc_scores_lut16:vector"] == launches["adc_scores_lut16"],
          f"path B: adc_scores_lut16 launches off the vectorised route {routes}")
    results["routes"]["path_b"] = routes

    plain_v, plain_r = search("plain")
    check(same_rows(cand_v, cand_r, plain_v, plain_r),
          "path B: kernel and plain ADC differ")
    exact = exact_scan(emb, PATH_ROWS, queries)[1]
    out["recall_at_10"] = recall_at_10(rows, exact)
    stored = np.arange(0, PATH_ROWS, PATH_ROWS // 32)[:32]
    sq = emb[torch.as_tensor(stored, device="cuda")].float()
    sv, sr = ivf.search_dispatch(sq, k=160, nprobe_blocks=128, bias=bias,
                                 normalize_queries=False, refine_overfetch=1)
    _v, self_rows = exact_rerank(host, sq.cpu().numpy(), sv.cpu().numpy(),
                                 sr.cpu().numpy(), k=10)
    out["self_rank1_stored_rows"] = float(np.mean(self_rows[:, 0] == stored))
    # limits from the first card run (PERF.md): both read 1.0
    check(bool(np.isfinite(vals).all()) and vals.shape == (32, 10)
          and out["recall_at_10"] >= 0.9
          and out["self_rank1_stored_rows"] >= 0.9, f"path B results {out}")
    out["search_ms_b32"] = host_ms(lambda: exact_rerank(
        host, q_np, *search(), k=10))
    out["search_qps_b32"] = 32 / out["search_ms_b32"] * 1e3
    out["dispatch_ms_b32"] = host_ms(search)
    log(f"  recall@10 {out['recall_at_10']:.3f}, stored rows self rank-1 "
        f"{out['self_rank1_stored_rows']:.3f}; kernel == plain ADC")
    log("  " + json.dumps(out))
    results["path_b"] = out
    return launches


# ------------------------------------------------------------------ phase 7
def write_service_checkpoint(results, store, emb) -> None:
    """Phase 7's inputs: phase 3's encoder as a local HF snapshot and its
    store as ``<data>/engine_checkpoint`` under ``SERVICE_TMP``."""
    from archi_tpu_torch.models.train_encoder import save_model_dir

    shutil.rmtree(SERVICE_TMP, ignore_errors=True)
    save_model_dir(os.path.join(SERVICE_TMP, "model"), emb.config, emb.model,
                   emb.tokenizer)
    t0 = time.perf_counter()
    store.save(os.path.join(SERVICE_TMP, "data", "engine_checkpoint"))
    results["service"] = {"rows": store.count(),
                          "checkpoint_save_s": time.perf_counter() - t0}
    log(f"  {store.count()} rows saved as engine_checkpoint in "
        f"{results['service']['checkpoint_save_s']:.1f} s; the encoder as a "
        f"local HF snapshot")


def sync() -> None:
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def check_routes(part: str, launches: dict, routes: dict,
                 names=("fused_topk", "encoder_attention")) -> None:
    """Every named kernel launched in the part, each launch on its fast
    route (tensor cores for bf16 top-k and attention, vectorised code loads
    for the ADC kernels)."""
    for name in names:
        route = "vector" if name.startswith("adc") else "tensor_core"
        check(launches[name] > 0, f"{part}: {name} never launched")
        check(routes[f"{name}:{route}"] == launches[name],
              f"{part}: {name} launches off the {route} route {routes}")


def check_planned_routes(part: str, launches: dict, routes: dict, names,
                         shapes) -> None:
    """``check_routes``, but a top-k over an f32 corpus (as ``shapes``
    counted them) is planned for the CUDA-core kernel and one over bf16 or
    int8 for the tensor cores: each must have taken its plan."""
    f32 = shapes.topk_launches("float32")
    check(routes["fused_topk:cuda_core"] == f32 and
          routes["fused_topk:tensor_core"] == launches["fused_topk"] - f32,
          f"{part}: top-k launches off their planned route ({f32} over "
          f"f32) {routes}")
    check("fused_topk" not in names or launches["fused_topk"] > 0,
          f"{part}: fused_topk never launched")
    check_routes(part, launches, routes,
                 [n for n in names if n != "fused_topk"])


def run_clients(store, requests, during=None):
    """``requests[c]`` = the (kind, query) calls of client c, each made from
    its own thread in turn (kind "hybrid" or "semantic", k=10).  ``during``
    runs on this thread once a quarter of the calls have returned.
    → (results by (c, j), latencies s, wall s)."""
    import threading

    out, lat, errors = {}, [], []
    lock = threading.Lock()
    quarter = threading.Event()
    n_calls = sum(len(r) for r in requests)

    def client(c):
        try:
            for j, (kind, q) in enumerate(requests[c]):
                t0 = time.perf_counter()
                r = (store.hybrid_search(q, k=10) if kind == "hybrid"
                     else store.similarity_search_with_score(q, k=10))
                dt = time.perf_counter() - t0
                with lock:
                    out[(c, j)] = r
                    lat.append(dt)
                    if len(out) >= n_calls // 4:
                        quarter.set()
        except Exception as exc:   # reported below: the run fails
            with lock:
                errors.append(f"client {c}: {exc!r}")
            quarter.set()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        check(quarter.wait(600), "clients made no progress")
        during()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client did not finish")
    check(not errors, f"client errors {errors[:3]}")
    return out, lat, wall


def latency_ms(lat) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def short_query(rng, vocab) -> str:
    return " ".join(vocab[int(i)] for i in rng.integers(
        0, 2000, int(rng.integers(1, 4))))


def service_flat(results, docs, vocab):
    """7a: restore phase 3's checkpoint through ``build_vectorstore`` with
    micro-batching at the defaults, serve 512 hybrid requests from 64
    clients, hold each against the direct path, then rerank.  → launches by
    part."""
    import numpy as np

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.reranker import MaxSimReranker
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.utils.metrics import METRICS

    out = results["service"]
    model_dir = os.path.join(SERVICE_TMP, "model")
    dm = {"embedding_name": "minilm", "model_dir": model_dir,
          "data_path": os.path.join(SERVICE_TMP, "data"), "index": {},
          "serving": {"micro_batch": {"enabled": True}}}
    t0 = time.perf_counter()
    st = build_vectorstore(dm, device=DEV)
    out["restore_s"] = time.perf_counter() - t0
    b = st._batcher
    check(type(st.index) is FlatIndex and st.count() == out["rows"]
          and b is not None
          and (b.max_batch, b.max_wait_s, len(b._workers)) == (32, 0.004, 2),
          "7a: the restored store is not the checkpoint's, micro-batched at "
          "the defaults")
    log(f"  7a: restored {st.count()} rows in {out['restore_s']:.1f} s "
        f"(FlatIndex, micro-batching 32 / 4 ms / 2 workers)")

    rng = np.random.default_rng(SEED + 7)
    miss = "zzzzqx unmatched service query"
    check(float(st.bm25.scores(miss, st.index.capacity).max()) <= 0.0,
          "7a: the BM25-miss query matches")
    reqs = []
    for c in range(SVC_CLIENTS):
        calls = [("hybrid", docs[int(i)])
                 for i in rng.integers(0, len(docs), 4)]
        calls += [("hybrid", short_query(rng, vocab)) for _ in range(3)]
        calls.append(("hybrid", miss if c % 8 == 0
                      else short_query(rng, vocab)))
        reqs.append(calls)
    n_req = SVC_CLIENTS * SVC_CALLS

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    b0 = METRICS.counter_value("archi_micro_batches_total")
    r0 = METRICS.counter_value("archi_micro_batched_requests_total")
    got, lat, wall = run_clients(st, reqs)
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    batches = METRICS.counter_value("archi_micro_batches_total") - b0
    served = METRICS.counter_value("archi_micro_batched_requests_total") - r0
    check_routes("7a", launches, routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7a: top-k fell back")

    # the same requests one at a time from one thread, the direct path
    t0 = time.perf_counter()
    want = {(c, j): st._hybrid_search_impl(q, k=10)
            for c in range(SVC_CLIENTS) for j, (_k, q) in enumerate(reqs[c])}
    seq_wall = time.perf_counter() - t0
    bad = [key for key, w in want.items() if not same_ranking(got[key], w)]
    check(not bad, f"7a: micro-batched results differ from the direct path "
                   f"at {bad[:8]}")
    check(served == n_req and served / batches > 1,
          f"7a: {served} requests in {batches} batches")
    out["flat"] = {"requests": n_req, "batches": batches,
                   "mean_batch": served / batches,
                   "qps_micro_batched": n_req / wall,
                   "qps_request_at_a_time": n_req / seq_wall,
                   **latency_ms(lat)}
    log("  7a: " + json.dumps(out["flat"]))

    # ---- MaxSim rerank of hybrid candidates, card against the CPU in f32
    rq = [reqs[c][j][1] for c, j in ((0, 0), (1, 1), (2, 4), (3, 5),
                                     (4, 2), (5, 6), (6, 3), (0, 7))]
    cands = [st.hybrid_search(q, k=RERANK_TOP) for q in rq]
    check(all(len(c) == RERANK_TOP for c in cands), "7a: short candidates")
    reset_launches()
    card = [MaxSimReranker(st._embedding_function).rerank(q, c)
            for q, c in zip(rq, cands)]
    sync()
    rr_launches, rr_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("rerank", rr_launches, rr_routes, ("encoder_attention",))
    cpu_rr = MaxSimReranker(TorchEmbedder(model_dir=model_dir, device="cpu"))
    err = 0.0
    for q, c, got_ in zip(rq, cands, card):
        ref = {d.metadata["chunk_id"]: s for d, s in cpu_rr.rerank(q, c)}
        check(len(got_) == RERANK_TOP and len(ref) == RERANK_TOP,
              "7a: rerank lost candidates")
        err = max(err, max(abs(s - ref[d.metadata["chunk_id"]])
                           for d, s in got_))
    out["rerank_max_abs_err_vs_cpu_f32"] = err
    check(err <= 1e-3, f"7a: rerank scores off the CPU's by {err:.3g}")
    log(f"  rerank: top {RERANK_TOP} of {len(rq)} queries, scores within "
        f"{err:.3g} of the same weights on the CPU in f32 (limit 1e-3)")
    st._batcher.close()
    return {"service_flat": (launches, routes),
            "service_rerank": (rr_launches, rr_routes)}


def service_hot_tail(results, docs, vocab):
    """7b: the checkpoint restored as a hot-tail index, new documents into
    the tail, a merge while 64 clients query."""
    import numpy as np

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = results["service"]
    dm = {"embedding_name": "minilm",
          "model_dir": os.path.join(SERVICE_TMP, "model"),
          "data_path": os.path.join(SERVICE_TMP, "data"),
          "index": {"hot_tail": True},
          "serving": {"micro_batch": {"enabled": True}}}
    t0 = time.perf_counter()
    st = build_vectorstore(dm, device=DEV)
    restore_s = time.perf_counter() - t0
    idx = st.index
    n_main = out["rows"]
    check(isinstance(idx, SegmentedFlatIndex) and idx.n_merged == n_main
          and idx.tail.n_rows == 0, "7b: not a hot-tail index over the rows")
    rng = np.random.default_rng(SEED + 8)
    new_docs = synthetic_texts(rng, vocab, HOT_DOCS, 96, prefix="hot")

    reset_launches()
    t0 = time.perf_counter()
    new_ids = st.add_texts(new_docs)
    ingest_s = time.perf_counter() - t0
    check(idx.tail.n_rows == HOT_DOCS and idx.n_merged == n_main,
          "7b: the documents did not land in the tail")

    def self_rank(label):
        bad = []
        for s0 in range(0, HOT_DOCS, 32):
            res = st.hybrid_search_batch(new_docs[s0:s0 + 32], k=10)
            for i, r in enumerate(res):
                ids = ids_of(r)
                if ids[:1] != [new_ids[s0 + i]] or len(set(ids)) != len(ids):
                    bad.append(s0 + i)
        check(not bad, f"7b {label}: documents {bad[:8]} miss rank 1 or "
                       f"list a row twice")

    self_rank("before the merge")
    bq = new_docs[:16] + [docs[i] for i in range(0, len(docs),
                                                  len(docs) // 16)][:16]
    brute = brute_force_hybrid(st, bq, 10)
    bad = [i for i, (g, w) in enumerate(zip(st.hybrid_search_batch(bq, k=10),
                                            brute))
           if not same_ranking(g, w)]
    check(not bad, f"7b: hybrid batch differs from brute force at {bad}")

    per = HOT_DOCS // SVC_CLIENTS
    reqs = [[("hybrid", new_docs[c * per + j]) for j in range(per)]
            for c in range(SVC_CLIENTS)]
    merge_s = []

    def merge():
        t = time.perf_counter()
        idx.merge()
        merge_s.append(time.perf_counter() - t)

    got, lat, wall = run_clients(st, reqs, during=merge)
    bad = [(c, j) for (c, j), r in got.items()
           if ids_of(r)[:1] != [new_ids[c * per + j]]
           or len(set(ids_of(r))) != len(r)]
    check(not bad, f"7b: during the merge {bad[:8]} missed rank 1 or listed "
                   f"a row twice")
    check(idx.n_merged == n_main + HOT_DOCS and idx.tail.n_rows == 0
          and idx._merge_epoch == 1, "7b: the merge did not fold the tail")
    self_rank("after the merge")
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7b", launches, routes)
    out["hot_tail"] = {"restore_s": restore_s, "ingest_s": ingest_s,
                       "merge_s": merge_s[0], "requests_during_merge":
                       len(got), "qps_during_merge": len(got) / wall,
                       **latency_ms(lat)}
    log("  7b: " + json.dumps(out["hot_tail"]))
    st._batcher.close()
    return {"service_hot_tail": (launches, routes)}


def service_xl(results, vocab):
    """7c: ``type: ivfpq_xl`` at the bootstrap's defaults: clustered rows
    through ``add_texts``, a snapshot, documents in the exact tail,
    micro-batched hybrid and semantic queries, recall, exact scores and a
    save/load round trip."""
    import numpy as np
    import torch

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.xl_index import XlPQIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = {}
    xl_dir = os.path.join(SERVICE_TMP, "xl")
    dm = {"embedding_name": "minilm",
          "model_dir": os.path.join(SERVICE_TMP, "model"),
          "data_path": os.path.join(xl_dir, "data"),
          "index": {"type": "ivfpq_xl",
                    "store_path": os.path.join(xl_dir, "plane.bin")},
          "serving": {"micro_batch": {"enabled": True}}}
    st = build_vectorstore(dm, device=DEV)
    idx = st.index
    check(isinstance(idx, XlPQIndex) and st.count() == 0
          and (idx.nlist, idx.block, idx.pq_m, idx.pq_refine_m, idx.ksub,
               idx.nprobe_blocks, idx.build_block_rows, idx.async_refresh)
          == (4096, 512, 48, 48, 16, 128, 1 << 17, True),
          "7c: not an XL index at the bootstrap's defaults")
    rng = np.random.default_rng(SEED + 9)
    corpus = ClusteredRows(XL_ROWS, SEED + 10, d=idx.dim)
    fill = synthetic_texts(rng, vocab, XL_ROWS, 3)

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    for s0 in range(0, XL_ROWS, FILL_BATCH):
        chunk = fill[s0:s0 + FILL_BATCH]
        st.add_texts(chunk, embeddings=corpus.rows(len(chunk)))
    if idx._refresh_thread is not None:
        idx._refresh_thread.join()
    out["fill_s"] = time.perf_counter() - t0
    # the background refreshes during the fill (the explicit refresh below
    # resets the counter): none may fail, e.g. on a plane that grows
    out["refresh_failures_during_fill"] = idx.refresh_failures
    check(idx.refresh_failures == 0,
          f"7c: {idx.refresh_failures} background refreshes failed")
    t0 = time.perf_counter()
    idx.refresh_snapshot()
    out["snapshot_build_s"] = time.perf_counter() - t0
    check(idx._n_snap == XL_ROWS and idx._ivf.packed
          and idx.refresh_failures == 0, "7c: no whole-plane snapshot")
    out["n_blocks"] = int(idx._ivf.code_blocks.shape[0])
    xl_docs = synthetic_texts(rng, vocab, XL_DOCS, 96, prefix="xl")
    t0 = time.perf_counter()
    xl_ids = st.add_texts(xl_docs)
    out["ingest_s"] = time.perf_counter() - t0
    check(idx._n_snap == XL_ROWS and idx.n_rows == XL_ROWS + XL_DOCS
          and len(idx.tail) == XL_DOCS, "7c: documents not in the tail")
    log(f"  7c: filled {XL_ROWS} rows in {out['fill_s']:.1f} s, snapshot "
        f"({out['n_blocks']} blocks) in {out['snapshot_build_s']:.1f} s, "
        f"{XL_DOCS} documents into the exact tail")

    sem_q = [short_query(rng, vocab) for _ in range(SVC_CLIENTS * 4)]
    probe = rng.choice(XL_DOCS, SVC_CLIENTS * 4, replace=False)
    reqs = [[("hybrid", xl_docs[probe[c * 4 + j]]) for j in range(4)]
            + [("semantic", sem_q[c * 4 + j]) for j in range(4)]
            for c in range(SVC_CLIENTS)]
    got, lat, wall = run_clients(st, reqs)
    bad = [c for c in range(SVC_CLIENTS) for j in range(4)
           if ids_of(got[(c, j)])[:1] != [xl_ids[probe[c * 4 + j]]]]
    check(not bad, f"7c: fresh documents miss rank 1 ({len(bad)})")
    check(all(len(r) == 10 for r in got.values()), "7c: short results")

    # exact scores of one semantic batch against the host plane's rows
    qs = sem_q[:32]
    res = st.similarity_search_batch(qs, k=10)
    embs = st._embed_queries(qs)
    embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True),
                             1e-12)
    q_bf16 = torch.from_numpy(embs).bfloat16().float().numpy()
    err = 0.0
    for b, r in enumerate(res):
        for d, s in r:
            row = idx._id_rows[d.metadata["chunk_id"]][0]
            plane = idx.store.get([row])[0]
            # snapshot rows: the exact host rerank (f32 query); tail rows:
            # the bf16 top-k, which rounds the query to the rows' type
            q = embs[b] if row < idx._n_snap else q_bf16[b]
            err = max(err, abs(s - float(plane @ q)))
    out["score_max_abs_err_vs_plane"] = err
    check(err <= 1e-4, f"7c: scores off the exact products by {err:.3g}")

    # recall@10 of semantic search through the store, clustered queries
    qv = corpus.rows(32)
    rows = []
    for q in qv.cpu().numpy():
        r = st.similarity_search_by_vector_with_score(q, k=10)
        rows.append(np.asarray([idx._id_rows[d.metadata["chunk_id"]][0]
                                for d, _s in r]))
    n = idx.n_rows
    plane = torch.from_numpy(np.array(idx.store._buf[:n]).view(np.int16)) \
        .to(DEV).view(torch.bfloat16)
    exact = exact_scan(plane, n, qv)[1]
    del plane
    out["recall_at_10"] = recall_at_10(rows, exact)
    check(out["recall_at_10"] >= 0.9,
          f"7c: recall@10 {out['recall_at_10']:.3f} < 0.9")

    # save/load round trip of the index
    path = os.path.join(xl_dir, "ckpt", "index.npz")
    before = idx.search(qv, k=10)
    t0 = time.perf_counter()
    idx.save(path)
    loaded = XlPQIndex.load(path, device=DEV)
    after = loaded.search(qv, k=10)
    out["save_load_s"] = time.perf_counter() - t0
    check(after[0] == before[0] and np.abs(after[1] - before[1]).max() <= 1e-6,
          "7c: the save/load round trip changed the results")
    del loaded
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7c", launches, routes,
                 ("fused_topk", "encoder_attention", "adc_scores_lut16"))
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7c: top-k fell back")
    out.update(requests=len(got), qps_micro_batched=len(got) / wall,
               **latency_ms(lat))
    results["service"]["xl"] = out
    log("  7c: " + json.dumps(out))
    st._batcher.close()
    return {"service_xl": (launches, routes)}


def http_json(url, path, body=None, *, method=None, token=None,
              timeout=600, user=None):
    """One request to a service with ``urllib`` (the card's machine has no
    ``requests``) → (status, decoded JSON body).  ``user``: the chat app's
    dev identity header (``X-User-Email``)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    if token is not None:
        req.add_header("X-Data-Token", token)
    if user is not None:
        req.add_header("X-User-Email", user)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


class HttpStore:
    """The data-manager service's query routes in the store's result shape
    ((Document, score) lists): what ``RemoteVectorStore`` does, over
    ``urllib``."""

    def __init__(self, url):
        self.url = url

    def _query(self, route, query, k):
        from archi_tpu_torch.utils.documents import Document

        code, body = http_json(self.url, route, {"query": query, "k": k})
        if code != 200:
            raise RuntimeError(f"{route}: HTTP {code}: {body}")
        return [(Document(h["page_content"], h["metadata"]), h["score"])
                for h in body]

    def hybrid_search(self, query, k=4):
        return self._query("/api/query/hybrid", query, k)

    def similarity_search_with_score(self, query, k=4):
        return self._query("/api/query/semantic", query, k)


def wait_ready(url, part, timeout=900):
    """Poll ``/api/ingestion/status`` until the initial ingestion's hold is
    released; fail on ``failed`` or after ``timeout`` seconds.  → (the last
    status, {status: seconds after the first poll when first seen})."""
    t0 = time.perf_counter()
    seen = {}
    while True:
        code, status = http_json(url, "/api/ingestion/status")
        check(code == 200, f"{part}: status answered {code}")
        seen.setdefault(status["status"], time.perf_counter() - t0)
        if status["status"] == "done":
            return status, seen
        check(status["status"] != "failed", f"{part}: ingestion failed")
        check(time.perf_counter() - t0 < timeout,
              f"{part}: not ready after {timeout} s ({status['status']})")
        time.sleep(0.1)


def scrape_metrics(url) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        m = re.match(r"^(\S+) (\S+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def service_data_manager(results, vocab):
    """7d: the port's data-manager service over HTTP.  ``build_app`` over a
    corpus of SVC_FILES local files (phase 3's encoder and vocabulary),
    ingested by the service's initial ingestion; 64 clients x 8 hybrid
    requests over HTTP, each equal to the direct path; a restart that
    restores the checkpoint with a zero diff; then semantic queries,
    uploads, a delete, ``/metrics`` and the token gate over HTTP.
    → launches by part."""
    import base64

    import numpy as np

    from archi_tpu_torch.bin.service_data_manager import build_app
    from archi_tpu_torch.data.chunking import character_split
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.utils.metrics import METRICS

    out = {"files": SVC_FILES}
    root = os.path.join(SERVICE_TMP, "dm")
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    rng = np.random.default_rng(SEED + 11)
    # about 4 KB a file: the words' mean length under phase 3's Zipf weights
    p = 1.0 / np.arange(1, len(vocab) + 1)
    mean_len = float((p / p.sum()) @ np.array([len(w) for w in vocab]))
    n_words = int(4096 / (mean_len + 1))
    t0 = time.perf_counter()
    texts = synthetic_texts(rng, vocab, SVC_FILES, n_words)
    n_chunks = 0
    for i, text in enumerate(texts):
        with open(os.path.join(corpus, f"f{i:05d}.txt"), "w") as f:
            f.write(text)
        n_chunks += len(character_split(text, 1000, 0))
    out["corpus_bytes"] = sum(len(t) for t in texts)
    log(f"  7d: {SVC_FILES} files, {out['corpus_bytes'] / SVC_FILES:.0f} "
        f"bytes and {n_chunks / SVC_FILES:.2f} chunks a file, written in "
        f"{time.perf_counter() - t0:.1f} s")
    overrides = {"data_manager": {
        "embedding_name": "minilm",
        "model_dir": os.path.join(SERVICE_TMP, "model"),
        "data_path": os.path.join(root, "data"),
        "db_path": os.path.join(root, "catalog.db"),
        "index": {"type": "flat", "dtype": "bfloat16"},
        "sources": {"local_files": {"paths": [corpus]}},
        "serving": {"micro_batch": {"enabled": True}}}}
    os.environ.pop("DATA_MANAGER_TOKEN", None)

    # ---- the service: initial ingestion, warmup, 64 clients, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    b0 = METRICS.counter_value("archi_micro_batches_total")
    r0 = METRICS.counter_value("archi_micro_batched_requests_total")
    t0 = time.perf_counter()
    app, ctx = build_app(overrides=overrides, device=DEV)
    url = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
    status, seen = wait_ready(url, "7d")
    out["ready_s"] = time.perf_counter() - t0
    # the sync began when the status first read "embedding" (polls 0.1 s
    # apart): what came before it was the collection of the files
    out["collect_s"] = seen.get("embedding")
    check(out["collect_s"] is not None, "7d: the sync was never seen")
    st = ctx.vectorstore
    b = st._batcher
    check(type(st.index) is FlatIndex and b is not None
          and (b.max_batch, b.max_wait_s, len(b._workers)) == (32, 0.004, 2),
          "7d: not a flat store micro-batched at the defaults")
    check(status["added"] == SVC_FILES and status["failed"] == 0
          and status["by_status"] == {"embedded": SVC_FILES},
          f"7d: ingest {status}")
    code, count = http_json(url, "/api/query/count")
    check(code == 200 and count["count"] == st.count() == n_chunks,
          f"7d: count {count} against {st.count()} in the store and "
          f"{n_chunks} chunks of the corpus")
    check((n_chunks, st.index.capacity) == (SVC_ROWS, SVC_CAPACITY),
          f"7d: {n_chunks} rows in a capacity of {st.index.capacity}, not "
          f"the shape at which phase 2 holds fused_topk")
    out.update(chunks=n_chunks, ingest_s=status["elapsed_s"],
               docs_per_s=SVC_FILES / status["elapsed_s"],
               chunks_per_s=n_chunks / status["elapsed_s"])
    log(f"  7d: ingested {SVC_FILES} files ({n_chunks} chunks) through the "
        f"service in {out['ingest_s']:.1f} s ({out['docs_per_s']:.0f} "
        f"docs/s, {out['chunks_per_s']:.0f} chunks/s; the collection "
        f"about {out['collect_s']:.1f} s of it), ready after "
        f"{out['ready_s']:.1f} s")

    miss = "zzzzqx unmatched service query"
    check(float(st.bm25.scores(miss, st.index.capacity).max()) <= 0.0,
          "7d: the BM25-miss query matches")
    reqs = []
    for c in range(SVC_CLIENTS):
        calls = [" ".join(texts[int(i)].split()[:96])
                 for i in rng.integers(0, SVC_FILES, 4)]
        calls += [short_query(rng, vocab) for _ in range(3)]
        calls.append(miss if c % 8 == 0 else short_query(rng, vocab))
        reqs.append([("hybrid", q) for q in calls])
    n_req = SVC_CLIENTS * SVC_CALLS
    got, lat, wall = run_clients(HttpStore(url), reqs)
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    batches = METRICS.counter_value("archi_micro_batches_total") - b0
    served = METRICS.counter_value("archi_micro_batched_requests_total") - r0
    check_routes("7d", launches, routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7d: top-k fell back")

    # every answer against the direct path in-process (not counted)
    bad = [(c, j) for c in range(SVC_CLIENTS)
           for j, (_kind, q) in enumerate(reqs[c])
           if not same_ranking(got[(c, j)], st._hybrid_search_impl(q, k=10))]
    check(not bad, f"7d: HTTP answers differ from the direct path at "
                   f"{bad[:8]}")
    check(served >= n_req and batches > 0 and served / batches > 1,
          f"7d: {served} requests in {batches} batches")
    out.update(requests=n_req, batches=batches, mean_batch=served / batches,
               qps_http=n_req / wall, **latency_ms(lat))
    log(f"  7d: {n_req} HTTP hybrid requests from {SVC_CLIENTS} clients at "
        f"{out['qps_http']:.1f} requests/s, p50 {out['p50_ms']:.1f} ms, "
        f"p99 {out['p99_ms']:.1f} ms, mean micro-batch "
        f"{out['mean_batch']:.1f}; equal to the direct path")
    keep = [(c, j) for c in range(4) for j in range(SVC_CALLS)]

    # ---- 7e: the port's chat service on this live data-manager
    chat_parts = service_chat(results, url, st, overrides, texts, vocab,
                              miss)
    # ---- 7f: the other entry points, evaluate and create
    chat_parts.update(entry_points(results, st, overrides, texts, vocab,
                                   corpus))

    # ---- restart on the same data path: the checkpoint, a zero diff
    app.shutdown()
    ctx.scheduler.stop()
    b.close()
    del st, ctx, app, b
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    app, ctx = build_app(overrides=overrides, device=DEV)
    out["restore_s"] = time.perf_counter() - t0
    url = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
    status, _seen = wait_ready(url, "7d restart")
    out["restart_ready_s"] = time.perf_counter() - t0
    st = ctx.vectorstore
    check((status["added"], status["removed"], status["failed"]) == (0, 0, 0)
          and st.count() == n_chunks,
          f"7d: the restart's sync was not a zero diff: {status}")
    http = HttpStore(url)
    for c, j in keep:
        check(same_ranking(http.hybrid_search(reqs[c][j][1], k=10),
                           got[(c, j)]),
              f"7d: after the restart query {(c, j)} answers otherwise")
    log(f"  7d: restarted, restored {st.count()} rows in "
        f"{out['restore_s']:.1f} s, ready after {out['restart_ready_s']:.1f} "
        f"s (sync +0 -0), {len(keep)} queries give the same top-10")

    # ---- semantic queries, uploads, a delete, /metrics over HTTP
    before = scrape_metrics(url)
    for c in range(8):
        check(len(http.similarity_search_with_score(reqs[c][0][1], k=10))
              == 10, "7d: a semantic query returned fewer than 10")
    uploads = synthetic_texts(rng, vocab, SVC_UPLOADS, n_words,
                              prefix="upload")
    hashes = []
    for i, text in enumerate(uploads):
        code, body = http_json(url, "/api/upload", {
            "filename": f"upload{i:02d}.txt", "sync": False,
            "content_b64": base64.b64encode(text.encode()).decode()})
        check(code == 200, f"7d: upload answered {code}")
        hashes.append(body["resource_hash"])
    t0 = time.perf_counter()
    code, sync_res = http_json(url, "/api/ingestion/trigger", {})
    out["resync_s"] = time.perf_counter() - t0
    up_chunks = sum(len(character_split(t, 1000, 0)) for t in uploads)
    check(code == 200 and sync_res["added"] == SVC_UPLOADS
          and sync_res["removed"] == 0
          and st.count() == n_chunks + up_chunks,
          f"7d: the resync after the uploads {sync_res}")

    def top_hashes(text):
        return [d.metadata["resource_hash"] for d, _s in http.hybrid_search(
            " ".join(text.split()[:24]), k=10)]

    for h, text in zip(hashes, uploads):
        check(h in top_hashes(text),
              "7d: an uploaded document is not in its own query's top-10")
    gone, gone_chunks = hashes[0], len(character_split(uploads[0], 1000, 0))
    code, body = http_json(url, f"/api/documents/{gone}", method="DELETE")
    check(code == 200 and body == {"deleted": True}, f"7d: delete {body}")
    want = n_chunks + up_chunks - gone_chunks
    deadline = time.perf_counter() + 120
    while http_json(url, "/api/query/count")[1]["count"] != want:
        check(time.perf_counter() < deadline,
              "7d: the deleted document's chunks stayed")
        time.sleep(0.1)
    check(gone not in top_hashes(uploads[0]),
          "7d: the deleted document is still found")
    after = scrape_metrics(url)
    sync()
    launches_w, routes_w = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7d writes", launches_w, routes_w)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7d: top-k fell back")
    rose = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
        'archi_engine_queries_total{kind="hybrid"}',
        'archi_engine_queries_total{kind="semantic"}',
        "archi_micro_batches_total_total",
        "archi_micro_batched_requests_total_total")}
    check(all(v > 0 for v in rose.values())
          and after["archi_index_chunks"] == want,
          f"7d: /metrics {rose}, {after.get('archi_index_chunks')} chunks")

    # ---- the token gate, on a second app over the same context
    os.environ["DATA_MANAGER_TOKEN"] = token = "7d-token"
    try:
        gated, _ = build_app(ctx=ctx, initial_ingestion=False)
        gurl = "http://127.0.0.1:%d" % gated.serve("127.0.0.1", 0,
                                                  background=True)
        check(http_json(gurl, "/api/query/count")[0] == 401
              and http_json(gurl, "/api/query/count", token="wrong")[0] == 401
              and http_json(gurl, "/api/query/count", token=token)
              == (200, {"count": want})
              and http_json(gurl, "/healthz")[0] == 200,
              "7d: the token gate")
        gated.shutdown()
    finally:
        os.environ.pop("DATA_MANAGER_TOKEN", None)
    app.shutdown()
    ctx.scheduler.stop()
    st._batcher.close()

    # what one catalog write costs on this disk: the collection commits
    # once a file and the sync twice (the statuses embedding, embedded)
    from archi_tpu_torch.data.catalog import CatalogService

    probe = CatalogService(os.path.join(root, "probe.db"))
    t0 = time.perf_counter()
    for i in range(256):
        probe.upsert_resource(f"probe{i}", display_name=f"p{i}")
    out["catalog_commit_ms"] = (time.perf_counter() - t0) / 256 * 1e3
    probe.close()
    log(f"  7d: semantic, {SVC_UPLOADS} uploads (resync "
        f"{out['resync_s']:.1f} s), a delete, /metrics and the token gate "
        f"over HTTP")
    results["service"]["data_manager"] = out
    log("  7d: " + json.dumps(out))
    return {"service_dm": (launches, routes),
            "service_dm_restart_writes": (launches_w, routes_w),
            **chat_parts}


# ---------------------------------------------------------------- part 7e
class KernelShapes:
    """Counts the shapes each kernel wrapper launches at while it is
    entered: attention's (B, S), top-k's (B, rows, bias kind, k, corpus
    dtype), the IVF-PQ search's ADC calls (wrapper, m, G, S).  It wraps the
    names the store, the encoder and the IVF-PQ search call
    (``engine.topk.fused_topk``, ``ops.attention.encoder_attention``,
    ``engine.ivfpq_index._ADC``); the wrappers still count their
    launches."""

    def __init__(self):
        import collections

        self.attention = collections.Counter()
        self.topk = collections.Counter()
        self.adc = collections.Counter()
        self._lock = threading.Lock()

    def topk_launches(self, dtype: str) -> int:
        """Top-k calls over a corpus of ``dtype`` (on CUDA tensors, each a
        launch)."""
        return sum(n for key, n in self.topk.items() if key[4] == dtype)

    def __enter__(self):
        from archi_tpu_torch.engine import ivfpq_index
        from archi_tpu_torch.engine import topk as engine_topk
        from archi_tpu_torch.ops import attention

        self._saved = (engine_topk.fused_topk, attention.encoder_attention,
                       dict(ivfpq_index._ADC))
        topk_fn, attn_fn, adc_fns = self._saved

        def fused_topk(queries, corpus, bias, n_active, *, k=10):
            with self._lock:
                self.topk[(int(queries.shape[0]), int(corpus.shape[0]),
                           "per-query" if bias.dim() == 2 else "shared",
                           int(k), str(corpus.dtype).replace("torch.", ""))
                          ] += 1
            return topk_fn(queries, corpus, bias, n_active, k=k)

        def adc(packed):
            fn = adc_fns[("kernel", packed)]
            name = "adc_scores_lut16" if packed else "adc_scores"

            def call(luts, codes_t):
                with self._lock:
                    self.adc[(name,) + tuple(int(v) for v in luts.shape[:2])
                             + (int(codes_t.shape[1]),)] += 1
                return fn(luts, codes_t)
            return call

        for packed in (False, True):
            ivfpq_index._ADC[("kernel", packed)] = adc(packed)

        def encoder_attention(q, k, v, key_bias, *, sm_scale):
            with self._lock:
                self.attention[(int(q.shape[0]), int(q.shape[1]))] += 1
            return attn_fn(q, k, v, key_bias, sm_scale=sm_scale)

        engine_topk.fused_topk = fused_topk
        attention.encoder_attention = encoder_attention
        return self

    def __exit__(self, *exc):
        from archi_tpu_torch.engine import ivfpq_index
        from archi_tpu_torch.engine import topk as engine_topk
        from archi_tpu_torch.ops import attention

        engine_topk.fused_topk, attention.encoder_attention = self._saved[:2]
        ivfpq_index._ADC.update(self._saved[2])
        return False

    def as_dict(self) -> dict:
        """bf16 top-k keys carry no dtype; others end in it."""
        return {"attention_b_s": {f"{b}x{s}": n for (b, s), n in
                                  sorted(self.attention.items())},
                "topk_b_rows_bias_k": {
                    f"{b}x{n}:{kind}:k{k}"
                    + ("" if dt == "bfloat16" else f":{dt}"): c
                    for (b, n, kind, k, dt), c in sorted(self.topk.items())},
                "adc_m_g_s": {f"{name}:m{m}:g{g}:s{s_}": c for
                              (name, m, g, s_), c in sorted(self.adc.items())}}


def sse_events(url, path, body, user, timeout=600):
    """``POST`` to an SSE route with ``urllib`` → the decoded events up to
    ``[DONE]``."""
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-User-Email": user})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"{path} answered {r.status}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            events.append(json.loads(line[6:]))
    return events


def as_sources(results):
    """(Document, score) results → the chat's ``sources``, as the
    wrapper formats them (deduplicated by document, 4 decimals)."""
    import types

    from archi_tpu_torch.orchestrator.output import PipelineOutput
    from archi_tpu_torch.web.chat_wrapper import ChatWrapper

    out = PipelineOutput(answer="", source_documents=[d for d, _ in results],
                         metadata={"retriever_scores": [s for _, s in
                                                        results]})
    return ChatWrapper._format_sources(
        types.SimpleNamespace(source_score_threshold=0.0), out)


def same_sources(got, want, tol=1.0001e-4):
    """Tie-aware over the chat's sources: equal length, scores within
    ``tol`` (one step of the 4 decimals), and a document in one list only
    sits at the cut, tied with it within ``tol``."""
    if len(got) != len(want):
        return False
    if any(abs(g["score"] - w["score"]) > tol for g, w in zip(got, want)):
        return False
    g = {x["resource_hash"]: x["score"] for x in got}
    w = {x["resource_hash"]: x["score"] for x in want}
    cut = min(w.values(), default=0.0)
    return all(abs(g.get(h, w.get(h)) - cut) <= tol for h in set(g) ^ set(w))


def service_chat(results, url, st, overrides, texts, vocab, miss):
    """7e: the port's chat service over 7d's live data-manager (``url``,
    its store ``st``).  (i) ``service_chat.build_app`` in remote mode on
    7d's config (micro-batching on) and ``services.chat.engine_url``:
    CHAT_CLIENTS x CHAT_CALLS chats over ``urllib``, half of the clients
    in one conversation each, every answer's sources equal to the direct
    hybrid search of its condensed query on 7d's store; (ii) the stream,
    history, feedback, document selection, the data-manager proxy, BYOK
    and ``/metrics``; (iv) the ReAct agent over the remote store, its model
    scripted to search once; then (iii) the chat in-process over 7d's
    store with the MaxSim rerank (over-fetch CHAT_OVERFETCH), each answer
    equal to the direct rerank.  → launches by part."""
    import copy
    import importlib.util
    import statistics

    import numpy as np

    from archi_tpu_torch.bin.bootstrap import build_context
    from archi_tpu_torch.bin.service_chat import build_app as build_chat
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.remote_vectorstore import RemoteVectorStore
    from archi_tpu_torch.engine.reranker import (MaxSimReranker,
                                                 RerankingRetriever)
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.orchestrator.archi import Archi
    from archi_tpu_torch.providers.chat_model import ScriptedChatModel
    from archi_tpu_torch.retrievers import HybridRetriever
    from archi_tpu_torch.utils.messages import Message, ToolCall

    t_part = time.perf_counter()
    out = {"clients": CHAT_CLIENTS, "calls": CHAT_CALLS}
    rng = np.random.default_rng(SEED + 13)

    def doc_words(n):
        return " ".join(texts[int(rng.integers(len(texts)))].split()[:n])

    # 7a's mix: document text, short queries, the BM25-miss query
    questions = [[doc_words(48), short_query(rng, vocab), doc_words(24),
                  miss if c % 8 == 0 else short_query(rng, vocab)]
                 for c in range(CHAT_CLIENTS)]

    # ---- (i) remote mode: one config for both services
    chat_over = copy.deepcopy(overrides)
    chat_over["services"] = {"chat": {"engine_url": url}}
    check(chat_over["data_manager"]["serving"]["micro_batch"]["enabled"],
          "7e: the config does not enable micro-batching")
    t0 = time.perf_counter()
    app, ctx = build_chat(overrides=chat_over, remote_engine=True)
    curl = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
    out["build_s"] = time.perf_counter() - t0
    crypto = importlib.util.find_spec("cryptography") is not None
    check(type(ctx.vectorstore) is RemoteVectorStore
          and ctx.vectorstore.base_url == url
          and (ctx.byok_store is None) == (not crypto),
          f"7e: the chat's context {type(ctx.vectorstore).__name__}, "
          f"BYOK {ctx.byok_store!r} (cryptography {crypto})")
    log(f"  7e: the chat service in remote mode on 7d's config "
        f"(micro-batching on) built in {out['build_s']:.2f} s; "
        f"cryptography {'imports' if crypto else 'absent: BYOK off'}")

    before = scrape_metrics(curl)
    answers, lat, errors = {}, [], []
    lock = threading.Lock()

    def client(c):
        user, cid = f"client{c:02d}@smoke", None
        try:
            for j, q in enumerate(questions[c]):
                body = {"message": q}
                if c % 2 == 0 and cid is not None:
                    body["conversation_id"] = cid
                t1 = time.perf_counter()
                code, r = http_json(curl, "/api/get_chat_response", body,
                                    user=user)
                dt = time.perf_counter() - t1
                if code != 200:
                    raise RuntimeError(f"HTTP {code}: {r}")
                cid = r["conversation_id"]
                with lock:
                    answers[(c, j)] = r
                    lat.append(dt)
        except Exception as exc:   # reported below: the run fails
            with lock:
                errors.append(f"client {c}: {exc!r}")

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    shapes = KernelShapes()
    with shapes:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CHAT_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              "7e: a chat client did not finish")
        check(not errors, f"7e: chat errors {errors[:3]}")
        n_chats = CHAT_CLIENTS * CHAT_CALLS

        # ---- (ii) the rest of the chat surface, over HTTP
        q0 = questions[1][0]
        events = sse_events(curl, "/api/get_chat_response_stream",
                            {"message": q0}, "stream@smoke")
        kinds = [e.get("type") for e in events]
        code, plain = http_json(curl, "/api/get_chat_response",
                                {"message": q0}, user="stream@smoke")
        n_chats += 1
        check(code == 200 and "retrieval" in kinds and kinds[-1] == "final"
              and events[-1]["answer"] == plain["answer"]
              and same_sources(events[-1]["sources"], plain["sources"]),
              f"7e: the stream's events {kinds} and answer differ from the "
              f"chat's")
        cid0 = answers[(0, 0)]["conversation_id"]
        code, convs = http_json(curl, "/api/conversations",
                                user="client00@smoke")
        code2, msgs = http_json(curl, f"/api/conversations/{cid0}",
                                user="client00@smoke")
        check(code == code2 == 200 and cid0 in [c["id"] for c in convs]
              and len(msgs) == 2 * CHAT_CALLS,
              f"7e: history {len(msgs)} messages in conversation {cid0}")
        code, fb = http_json(curl, "/api/feedback", {
            "message_id": answers[(0, 0)]["message_id"], "rating": "like"},
            user="client00@smoke")
        check(code == 200 and fb.get("feedback_id"), f"7e: feedback {fb}")
        # document selection: the top source disabled in one conversation
        code, first = http_json(curl, "/api/get_chat_response",
                                {"message": q0}, user="select@smoke")
        top = first["sources"][0]["resource_hash"]
        code2, _ = http_json(
            curl, f"/api/conversations/{first['conversation_id']}/documents",
            {top: False}, method="PUT", user="select@smoke")
        code3, second = http_json(curl, "/api/get_chat_response", {
            "message": q0, "conversation_id": first["conversation_id"]},
            user="select@smoke")
        n_chats += 2
        check(code == code2 == code3 == 200 and second["sources"]
              and top not in [x["resource_hash"] for x in second["sources"]],
              "7e: a disabled document is still cited in its conversation")
        check(http_json(curl, "/api/dm/status") ==
              http_json(url, "/api/ingestion/status"),
              "7e: the proxied status differs from the data-manager's")
        byok_code, byok = http_json(curl, "/api/user/api_key", {
            "provider": "openai", "api_key": "sk-smoke"}, user="k@smoke")
        check(byok_code == (200 if crypto else 501),
              f"7e: BYOK answered {byok_code} {byok}")
        after = scrape_metrics(curl)
        rose = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
            "archi_chat_messages_total", "archi_chat_duration_seconds_count")}
        check(set(rose.values()) == {float(n_chats)},
              f"7e: /metrics rose by {rose}, not by {n_chats} chats")

        # ---- (iv) the ReAct agent over the remote store, scripted
        agent_q = doc_words(32)
        agent = Archi("BaseReActAgent", config=ctx.config,
                      vectorstore=ctx.vectorstore)
        agent.pipeline.llms["agent_model"] = ScriptedChatModel([
            Message("assistant", "", tool_calls=[ToolCall(
                "search_vectorstore_hybrid", {"query": agent_q}, "c1")]),
            Message("assistant", "Answered from the corpus.")])
        agent_out = agent.invoke(history=[("User", "what does it say?")])
        sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7e", launches, routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7e: top-k fell back")
    out["shapes_remote"] = shapes.as_dict()

    # every answer against the direct path on 7d's store (not counted)
    bad, cond_chars = [], []
    for key, r in sorted(answers.items()):
        cond = r["metadata"]["condensed_output"]
        cond_chars.append(len(cond))
        want = as_sources(st._hybrid_search_impl(
            cond, k=5, semantic_weight=0.4, bm25_weight=0.6))
        if not r["sources"] or not same_sources(r["sources"], want):
            bad.append(key)
    check(not bad, f"7e: chat sources differ from the direct hybrid search "
                   f"at {bad[:8]}")
    want = st._hybrid_search_impl(agent_q, k=5, semantic_weight=0.4,
                                  bm25_weight=0.6)
    got = list(zip(agent_out.source_documents,
                   agent_out.metadata["retriever_scores"]))
    check(agent_out.answer == "Answered from the corpus."
          and agent_out.metadata["pipeline_used"] == "BaseReActAgent"
          and same_ranking(got, want),
          "7e: the agent's sources differ from the direct hybrid search")

    # the retrieval's share of a chat: the same condensed queries, one at a
    # time, through the data-manager's query route
    timing = [r["timing"] for r in answers.values()]
    retrieval = []
    for r in list(answers.values())[:CHAT_CLIENTS]:
        t1 = time.perf_counter()
        code, _ = http_json(url, "/api/query/hybrid", {
            "query": r["metadata"]["condensed_output"], "k": 5,
            "semantic_weight": 0.4, "bm25_weight": 0.6})
        retrieval.append(time.perf_counter() - t1)
        check(code == 200, f"7e: /api/query/hybrid answered {code}")

    def med_ms(key):
        return statistics.median(t[key] for t in timing) * 1e3

    out.update(
        chats=CHAT_CLIENTS * CHAT_CALLS,
        chats_per_s=CHAT_CLIENTS * CHAT_CALLS / wall, **latency_ms(lat),
        lock_wait_ms=med_ms("server_received_to_lock_acquisition"),
        history_ms=med_ms("lock_acquisition_to_query_convo_history"),
        chain_ms=med_ms("chain_started_to_chain_finished"),
        inserts_ms=med_ms("chain_finished_to_inserts_finished"),
        msg_ms=med_ms("msg_duration"),
        retrieval_ms=statistics.median(retrieval) * 1e3,
        condensed_chars_median=statistics.median(cond_chars),
        condensed_chars_max=max(cond_chars))
    out["retrieval_share_of_chain"] = out["retrieval_ms"] / out["chain_ms"]
    log(f"  7e: {out['chats']} chats from {CHAT_CLIENTS} clients over HTTP "
        f"at {out['chats_per_s']:.1f} chats/s, p50 {out['p50_ms']:.0f} ms, "
        f"p99 {out['p99_ms']:.0f} ms; medians: lock wait "
        f"{out['lock_wait_ms']:.1f}, history {out['history_ms']:.1f}, chain "
        f"{out['chain_ms']:.1f} (the retrieval over HTTP alone "
        f"{out['retrieval_ms']:.1f}), inserts {out['inserts_ms']:.1f} ms; "
        f"every answer's sources = the direct hybrid search")
    log(f"  7e: stream, history, feedback, document selection, the proxy, "
        f"BYOK {byok_code} and /metrics (+{n_chats} chats) "
        f"as the chat app promises; the scripted agent's sources = the "
        f"direct search")
    log("  7e remote shapes: " + json.dumps(out["shapes_remote"]))
    app.shutdown()
    ctx.scheduler.stop()

    # ---- (iii) in-process over 7d's store, with the MaxSim rerank
    rr_over = copy.deepcopy(overrides)
    rr_over["data_manager"]["serving"] = {"micro_batch": {"enabled": False}}
    rr_over["data_manager"]["retrievers"] = {"hybrid_retriever": {
        "rerank": {"enabled": True, "overfetch": CHAT_OVERFETCH}}}
    batcher = st._batcher
    ictx = build_context(overrides=rr_over, vectorstore=st)
    check(ictx.vectorstore is st and st._batcher is batcher,
          "7e: the in-process context changed 7d's store")
    iapp, _ = build_chat(ctx=ictx)
    iurl = f"http://127.0.0.1:{iapp.serve('127.0.0.1', 0, background=True)}"
    # a question of each kind, the BM25-miss query last
    rr_questions = [questions[i][i % CHAT_CALLS]
                    for i in range(CHAT_RERANK - 1)] + [questions[0][-1]]
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    rr_shapes = KernelShapes()
    rr_answers, rr_lat = [], []
    with rr_shapes:
        for q in rr_questions:
            t1 = time.perf_counter()
            code, r = http_json(iurl, "/api/get_chat_response",
                                {"message": q}, user="rerank@smoke")
            rr_lat.append(time.perf_counter() - t1)
            check(code == 200, f"7e rerank: HTTP {code}: {r}")
            rr_answers.append(r)
        sync()
    rr_launches, rr_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7e rerank", rr_launches, rr_routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0,
          "7e rerank: top-k fell back")
    direct = RerankingRetriever(
        HybridRetriever(st, k=CHAT_OVERFETCH, bm25_weight=0.6,
                        semantic_weight=0.4),
        MaxSimReranker(st._embedding_function), k=5)
    bad = [i for i, r in enumerate(rr_answers) if not same_sources(
        r["sources"], as_sources(direct.invoke(
            r["metadata"]["condensed_output"])))]
    check(not bad, f"7e rerank: sources differ from the direct rerank at "
                   f"{bad}")
    iapp.shutdown()
    ictx.scheduler.stop()
    out["rerank"] = {"chats": len(rr_answers),
                     "chat_ms_median": statistics.median(rr_lat) * 1e3,
                     "shapes": rr_shapes.as_dict()}
    log(f"  7e: {len(rr_answers)} in-process chats with the MaxSim rerank "
        f"(over-fetch {CHAT_OVERFETCH}) at a median "
        f"{out['rerank']['chat_ms_median']:.1f} ms, each = the direct rerank "
        f"(no attach_reranker)")
    log("  7e rerank shapes: " + json.dumps(out["rerank"]["shapes"]))
    out["seconds"] = time.perf_counter() - t_part
    results["service"]["chat"] = out
    log("  7e: " + json.dumps(out))
    return {"service_chat": (launches, routes),
            "service_chat_rerank": (rr_launches, rr_routes)}


# ---------------------------------------------------------------- part 7f
def same_docs(got_docs, want_wide, k, tol=1.0001e-4):
    """Tie-aware over documents without scores (the grading pipeline's):
    the i-th document is the direct search's i-th, or scores within ``tol``
    of it (its score read from ``want_wide``, a deeper direct result)."""
    want = want_wide[:k]
    if len(got_docs) != len(want):
        return False
    score = {d.metadata["chunk_id"]: s for d, s in want_wide}
    for g, (w, ws) in zip(got_docs, want):
        gid = g.metadata["chunk_id"]
        if gid != w.metadata["chunk_id"] and (
                gid not in score or abs(score[gid] - ws) > tol):
            return False
    return True


class Recorder:
    """Records each ``Archi.invoke``'s output by pipeline while entered:
    the grader, the bots and the ticket processor build their ``Archi``
    inside the port's entry points, and their answers carry no sources."""

    def __init__(self):
        import collections

        self.outputs = collections.defaultdict(list)
        self._lock = threading.Lock()

    def __enter__(self):
        from archi_tpu_torch.orchestrator.archi import Archi

        self._saved = invoke = Archi.invoke
        rec = self

        def recorded(archi, **kwargs):
            out = invoke(archi, **kwargs)
            with rec._lock:
                rec.outputs[type(archi.pipeline).__name__].append(
                    (kwargs, out))
            return out

        Archi.invoke = recorded
        return self

    def __exit__(self, *exc):
        from archi_tpu_torch.orchestrator.archi import Archi

        Archi.invoke = self._saved
        return False


def entry_services(st, overrides, texts, vocab):
    """7f (i): the grader, the account tool, the bots and the ticket
    processor over 7d's live store (``st``), each from the port's entry
    point with in-process fake transports.  → (launches, routes, out)."""
    import copy

    import numpy as np

    from archi_tpu_torch.bin import (service_create_account,
                                     service_mattermost, service_piazza,
                                     service_redmine)
    from archi_tpu_torch.bin.bootstrap import build_context
    from archi_tpu_torch.bin.service_grader import build_app as build_grader
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.providers.chat_model import ScriptedChatModel
    from archi_tpu_torch.utils.messages import Message, ToolCall

    out = {}
    rng = np.random.default_rng(SEED + 17)
    root = os.path.join(SERVICE_TMP, "7f")

    def doc_words(n):
        return " ".join(texts[int(rng.integers(len(texts)))].split()[:n])

    # one context over 7d's store, its own app database (7d's batcher kept)
    over = copy.deepcopy(overrides)
    over["data_manager"].update(
        data_path=os.path.join(root, "data"),
        db_path=os.path.join(root, "catalog.db"),
        serving={"micro_batch": {"enabled": False}})
    batcher = st._batcher
    t0 = time.perf_counter()
    ctx = build_context(overrides=over, vectorstore=st, device=DEV)
    check(ctx.vectorstore is st and st._batcher is batcher,
          "7f: the context changed 7d's store")
    app, _ = build_grader(ctx=ctx)
    gurl = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
    out["grader_build_s"] = time.perf_counter() - t0
    submissions = [doc_words(int(rng.integers(16, 80)))
                   for _ in range(ENTRY_GRADES)]
    tickets = [doc_words(32) for _ in range(ENTRY_TICKETS)]
    questions = {bot: [doc_words(24) if i % 2 else short_query(rng, vocab)
                       for i in range(ENTRY_QUESTIONS)]
                 for bot in ("mattermost", "piazza")}

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    shapes, rec = KernelShapes(), Recorder()
    with shapes, rec:
        # ---- the grader: ENTRY_GRADES submissions at once over HTTP
        grades, errors = {}, []

        def grade(i):
            try:
                grades[i] = http_json(gurl, "/api/grade", {
                    "submission": submissions[i], "rubric": "the corpus",
                    "max_points": 10}, user=f"student{i:02d}@smoke")
            except Exception as exc:   # reported below: the run fails
                errors.append(f"grade {i}: {exc!r}")

        threads = [threading.Thread(target=grade, args=(i,))
                   for i in range(ENTRY_GRADES)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["grade_wall_s"] = time.perf_counter() - t0
        check(not errors and len(grades) == ENTRY_GRADES,
              f"7f: grading errors {errors[:3]}")
        check(all(code == 200 and body["status"] == "pending"
                  for code, body in grades.values()),
              f"7f: a grade answered {[g for g in grades.values()][:2]}")
        code, subs = http_json(gurl, "/api/submissions?status=pending")
        check(code == 200 and len(subs) == ENTRY_GRADES,
              f"7f: {len(subs)} pending submissions")
        app.shutdown()

        # ---- an account whose password verifies
        service_create_account.create_account(
            ctx.users, "grader@smoke", "smoke-pw", ["user", "admin"])
        check(ctx.users.verify_password("grader@smoke", "smoke-pw")
              and not ctx.users.verify_password("grader@smoke", "wrong"),
              "7f: the created account's password does not verify")

        # ---- the bots: one step answers every question
        posted = {}
        t0 = time.perf_counter()
        for name, module in (("mattermost", service_mattermost),
                             ("piazza", service_piazza)):
            items = [{"id": f"{name}{i}", "question": q, "root_id": ""}
                     for i, q in enumerate(questions[name])]
            posted[name] = []
            bot, bctx = module.build_bot(
                ctx=ctx, fetch_fn=lambda items=items: items,
                post_fn=lambda item, ans, name=name: posted[name].append(
                    (item["id"], ans)))
            check(bctx is ctx, "7f: the bot built its own context")
            n = bot.step()
            check(n == ENTRY_QUESTIONS and bot.step() == 0
                  and len(posted[name]) == ENTRY_QUESTIONS,
                  f"7f: {name} answered {n} of {ENTRY_QUESTIONS}")
        out["bots_s"] = time.perf_counter() - t0

        # ---- the ticket processor, its agent scripted to search once
        class Redmine:
            def __init__(self):
                self.notes = []

            def add_note(self, issue_id, note, private=False):
                self.notes.append((issue_id, note, private))

        script = []
        for q in tickets:
            script += [Message("assistant", "", tool_calls=[ToolCall(
                "search_vectorstore_hybrid", {"query": q}, "c1")]),
                Message("assistant", "Drafted from the corpus.")]
        issues = [{"id": i + 1, "subject": f"ticket {i}", "description": q}
                  for i, q in enumerate(tickets)]
        redmine = Redmine()
        proc, _ = service_redmine.build_processor(
            ctx=ctx, list_issues=lambda status: issues
            if status == "open" else [], redmine_client=redmine)
        proc.agent.pipeline.llms["agent_model"] = ScriptedChatModel(script)
        t0 = time.perf_counter()
        n = proc.step()
        out["tickets_s"] = time.perf_counter() - t0
        check(n == ENTRY_TICKETS and proc.step() == 0
              and len(redmine.notes) == ENTRY_TICKETS
              and all(note.startswith("[AI draft]\nDrafted") and private
                      for _i, note, private in redmine.notes),
              f"7f: {n} tickets drafted, notes {redmine.notes[:2]}")
        sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("7f services", launches, routes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "7f: top-k fell back")
    ctx.scheduler.stop()

    # every output against the direct search on 7d's store (not counted)
    graded = rec.outputs["GradingPipeline"]
    check(len(graded) == ENTRY_GRADES, f"7f: {len(graded)} gradings")
    bad = [kw["submission"][:40] for kw, o in graded if not same_docs(
        o.source_documents, st._similarity_search_impl(
            kw["submission"][:500], k=8), 3)]
    check(not bad, f"7f: grading sources differ from the direct semantic "
                   f"search for {bad[:4]}")
    answered = rec.outputs["QAPipeline"]
    check(len(answered) == 2 * ENTRY_QUESTIONS,
          f"7f: {len(answered)} bot answers")
    bad = [i for i, (_kw, o) in enumerate(answered) if not same_ranking(
        list(zip(o.source_documents, o.metadata["retriever_scores"])),
        st._hybrid_search_impl(o.metadata["condensed_output"], k=5,
                               semantic_weight=0.4, bm25_weight=0.6))]
    check(not bad, f"7f: bot answers' sources differ from the direct hybrid "
                   f"search at {bad[:8]}")
    drafted = rec.outputs["CMSCompOpsAgent"]
    check(len(drafted) == ENTRY_TICKETS, f"7f: {len(drafted)} drafts")
    bad = [i for i, (_kw, o) in enumerate(drafted) if not same_ranking(
        list(zip(o.source_documents, o.metadata["retriever_scores"])),
        st._hybrid_search_impl(tickets[i], k=5, semantic_weight=0.4,
                               bm25_weight=0.6))]
    check(not bad, f"7f: drafts' sources differ from the direct hybrid "
                   f"search at {bad}")
    out.update(grades=ENTRY_GRADES,
               grades_per_s=ENTRY_GRADES / out["grade_wall_s"],
               bot_answers=2 * ENTRY_QUESTIONS,
               bot_answers_per_s=2 * ENTRY_QUESTIONS / out["bots_s"],
               tickets=ENTRY_TICKETS, shapes=shapes.as_dict())
    log(f"  7f: {ENTRY_GRADES} grades at once over HTTP in "
        f"{out['grade_wall_s']:.2f} s ({out['grades_per_s']:.1f}/s), an "
        f"account, {2 * ENTRY_QUESTIONS} bot answers "
        f"({out['bot_answers_per_s']:.1f}/s) and {ENTRY_TICKETS} drafted "
        f"tickets; every source = the direct search")
    log("  7f service shapes: " + json.dumps(out["shapes"]))
    return launches, routes, out


def entry_evaluate():
    """7f (ii): ``service_benchmark.run_benchmark`` on a config of its own
    (the fixture corpus as local files, phase 3's encoder, flat bf16,
    SOURCES and RETRIEVAL), then ``evaluate --fixture`` and ``--beir``
    through the port's CLI on the card and on the CPU.
    → {part: (launches, routes)}, out."""
    import importlib.util

    from archi_tpu_torch.benchmarking.beir import write_fixture_beir
    from archi_tpu_torch.benchmarking.fixture import fixture_corpus
    from archi_tpu_torch.bin.service_benchmark import run_benchmark
    from archi_tpu_torch.data.chunking import character_split
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out, parts = {}, {}
    root = os.path.join(SERVICE_TMP, "7f", "bench")
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    docs, fixture_qs = fixture_corpus()
    for name, text, _meta in docs:
        with open(os.path.join(corpus, name), "w") as f:
            f.write(text)
    rows = sum(len(character_split(t, 1000, 0)) for _n, t, _m in docs)
    check(rows == EVAL_ROWS, f"7f: the fixture has {rows} chunks, not the "
                             f"{EVAL_ROWS} at which phase 2 holds fused_topk")
    queries = [{"question": q["question"], "reference_sources": [
        {"display_name": s["source"]} for s in q["reference_sources"]]}
        for q in fixture_qs]
    over = {"data_manager": {
        "embedding_name": "minilm",
        "model_dir": os.path.join(SERVICE_TMP, "model"),
        "data_path": os.path.join(root, "data"),
        "db_path": os.path.join(root, "catalog.db"),
        "index": {"type": "flat", "dtype": "bfloat16"},
        "sources": {"local_files": {"paths": [corpus]}}},
        "services": {"benchmarking": {
            "modes": ["SOURCES", "RETRIEVAL"],
            "out_dir": os.path.join(root, "out")}}}

    # ---- the benchmark service, counted
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    shapes = KernelShapes()
    t0 = time.perf_counter()
    with shapes:
        report, ctx = run_benchmark(queries, overrides=over, device=DEV)
        sync()
    out["benchmark_s"] = time.perf_counter() - t0
    parts["entry_benchmark"] = (dict(LAUNCHES), dict(ROUTE_LAUNCHES))
    check_routes("7f benchmark", *parts["entry_benchmark"])
    check(engine_topk.FUSED_FALLBACKS["count"] == 0,
          "7f benchmark: top-k fell back")
    st = ctx.vectorstore
    check(st.count() == EVAL_ROWS and st.index.capacity == EVAL_CAPACITY,
          f"7f: the benchmark's store holds {st.count()} rows in "
          f"{st.index.capacity}")
    totals = report["totals"]
    check(totals["n_questions"] == len(queries)
          and 0.0 <= totals["source_accuracy"] <= 1.0
          and 0.0 < totals["recall_at_k"] <= 1.0 and totals["k"] == 10,
          f"7f: benchmark totals {totals}")
    # each question's sources against the direct hybrid search (the
    # Benchmarker asks one question at a time, as the direct path does)
    bad = [i for i, q in enumerate(report["questions"].values())
           if [m["chunk_id"] for m in q["sources_metadata"]] !=
           [d.metadata["chunk_id"] for d, _s in st._hybrid_search_impl(
               q["question"], k=5, semantic_weight=0.4, bm25_weight=0.6)]]
    check(not bad, f"7f: benchmark sources differ from the direct search "
                   f"at questions {bad[:8]}")
    ctx.scheduler.stop()
    out["benchmark"] = totals
    out["benchmark_shapes"] = shapes.as_dict()
    log(f"  7f: service_benchmark over {len(docs)} fixture files "
        f"({EVAL_ROWS} chunks, MiniLM-L6, flat bf16) in "
        f"{out['benchmark_s']:.1f} s: " + json.dumps(totals))
    del st, ctx

    # ---- archi-tpu-torch evaluate --fixture / --beir, card and CPU
    beir_dir = os.path.join(root, "beir")
    write_fixture_beir(beir_dir, n_topics=BEIR_TOPICS,
                       docs_per_topic=BEIR_DOCS_PER_TOPIC)
    use_click = importlib.util.find_spec("click") is not None
    out["evaluate_route"] = "CliRunner" if use_click else "run_evaluate"

    def evaluate(kind, dev):
        """``evaluate --fixture`` or ``--beir`` on ``dev`` → (the totals or
        the BEIR metrics, seconds)."""
        out_dir = os.path.join(root, f"eval_{kind}_{dev}")
        t1 = time.perf_counter()
        if use_click:
            from click.testing import CliRunner

            from archi_tpu_torch.cli.cli_main import cli

            args = ["--fixture"] if kind == "fixture" else ["--beir",
                                                            beir_dir]
            r = CliRunner().invoke(cli, ["evaluate", *args, "--device", dev,
                                         "-o", out_dir])
            if r.exception is not None and not isinstance(r.exception,
                                                          SystemExit):
                raise r.exception
            check(r.exit_code == 0, f"7f: evaluate {args}: {r.output}")
            got = json.loads(r.output[:r.output.rindex("}") + 1])
        else:
            from archi_tpu_torch.cli.evaluate import run_evaluate

            got = run_evaluate(fixture=kind == "fixture",
                               beir=beir_dir if kind == "beir" else None,
                               device=dev, out=out_dir)
            got = got.get("totals", got)
        return got, time.perf_counter() - t1

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    shapes = KernelShapes()
    runs = {}
    with shapes:
        for dev in (DEV, "cpu"):
            for kind in ("fixture", "beir"):
                runs[(kind, dev)] = evaluate(kind, dev)
        sync()
    parts["entry_evaluate"] = (dict(LAUNCHES), dict(ROUTE_LAUNCHES))
    check_routes("7f evaluate", *parts["entry_evaluate"],
                 names=("fused_topk",))
    check(engine_topk.FUSED_FALLBACKS["count"] == 0,
          "7f evaluate: top-k fell back")
    (card, card_s), (cpu, cpu_s) = runs[("fixture", DEV)], \
        runs[("fixture", "cpu")]
    same = {k: card[k] == cpu[k] for k in (
        "n_questions", "source_accuracy", "relative_source_accuracy",
        "recall_at_k", "k")}
    check(all(same.values()), f"7f: evaluate --fixture on the card {card} "
                              f"and on the CPU {cpu}")
    check(card["recall_at_k"] >= 0.99,
          f"7f: evaluate recall@10 {card['recall_at_k']}")
    (bcard, _), (bcpu, _) = runs[("beir", DEV)], runs[("beir", "cpu")]
    check(all(abs(bcard[k] - bcpu[k]) <= 1e-4 for k in (
        "ndcg@10", "recall@10", "recall@100", "mrr@10"))
          and (bcard["documents"], bcard["queries"]) ==
          (BEIR_TOPICS * BEIR_DOCS_PER_TOPIC, BEIR_TOPICS),
          f"7f: evaluate --beir on the card {bcard} and on the CPU {bcpu}")
    out.update(evaluate_card=card, evaluate_cpu=cpu,
               evaluate_s={"card": card_s, "cpu": cpu_s},
               beir_card=bcard, beir_cpu=bcpu,
               evaluate_shapes=shapes.as_dict())
    log(f"  7f: evaluate --fixture through {out['evaluate_route']}: "
        f"recall@10 {card['recall_at_k']}, source accuracy "
        f"{card['source_accuracy']} on the card = the CPU's; query_qps "
        f"{card['query_qps']} on the card, {cpu['query_qps']} on the CPU "
        f"({card_s:.1f} s and {cpu_s:.1f} s a run)")
    log(f"  7f: evaluate --beir: {json.dumps(bcard)} on the card, nDCG, "
        f"recall and MRR within 1e-4 of the CPU's")
    log("  7f evaluate shapes: " + json.dumps(out["evaluate_shapes"]))
    return parts, out


def entry_create(corpus):
    """7f (iii): ``archi-tpu-torch create`` through the port's
    ``DeploymentManager``: the data-manager and the chat as real
    processes on the card over 256 of 7d's files, queried and chatted with
    over HTTP, then deleted.  → out."""
    import signal

    from archi_tpu_torch.cli import deployment
    from archi_tpu_torch.config.manager import ConfigurationManager
    from archi_tpu_torch.utils.documents import Document

    out = {}
    root = os.environ["ARCHI_TPU_DEPLOYMENTS"]
    check(deployment.DEPLOY_ROOT == root,
          "7f: the deployment root was read before ARCHI_TPU_DEPLOYMENTS "
          "was set")
    files = os.path.join(SERVICE_TMP, "7f", "deploy_corpus")
    os.makedirs(files)
    names = sorted(os.listdir(corpus))[:CREATE_FILES]
    for name in names:
        shutil.copy(os.path.join(corpus, name), files)
    dm_port, chat_port = free_port(), free_port()
    cm = ConfigurationManager(overrides={
        "name": "smoke",
        "data_manager": {
            "embedding_name": "minilm",
            "model_dir": os.path.join(SERVICE_TMP, "model"),
            "index": {"type": "flat", "dtype": "bfloat16"},
            "sources": {"local_files": {"paths": [files]}},
            "serving": {"micro_batch": {"enabled": True}}},
        "services": {
            "data_manager": {"enabled": True, "host": "127.0.0.1",
                             "port": dm_port},
            "chat": {"enabled": True, "host": "127.0.0.1",
                     "port": chat_port}}})
    cm.validate()
    mgr = deployment.DeploymentManager("smoke")
    reaped = {}

    def reap(name, pid):
        # the children of this process: reaped here, so that a stopped
        # one is gone (its exit status kept for the failure report)
        try:
            reaped[name] = os.waitpid(pid, 0)[1]
        except ChildProcessError:
            reaped[name] = None

    t0 = time.perf_counter()
    started = {}
    try:
        started = mgr.start(cm.config)
        check(list(started) == ["data_manager", "chat"],
              f"7f: create started {list(started)}")
        for name, info in started.items():
            threading.Thread(target=reap, args=(name, info["pid"]),
                             daemon=True).start()
        dm = f"http://127.0.0.1:{dm_port}"
        chat = f"http://127.0.0.1:{chat_port}"
        deadline = time.perf_counter() + 600
        while True:
            check(not reaped, f"7f: a service exited: {reaped}")
            try:
                code, status = http_json(dm, "/api/ingestion/status",
                                         timeout=10)
                if code == 200 and status["status"] == "done":
                    break
                check(status.get("status") != "failed",
                      f"7f: the ingestion failed {status}")
            except OSError:
                pass
            check(time.perf_counter() < deadline,
                  "7f: the data-manager was not ready in 600 s")
            time.sleep(0.2)
        out["dm_ready_s"] = time.perf_counter() - t0
        check(status["added"] == CREATE_FILES and status["failed"] == 0,
              f"7f: the spawned ingestion {status}")
        while True:
            try:
                if http_json(chat, "/healthz", timeout=10)[0] == 200:
                    break
            except OSError:
                pass
            check(not reaped and time.perf_counter() < deadline,
                  f"7f: the chat was not ready ({reaped})")
            time.sleep(0.2)
        out["chat_ready_s"] = time.perf_counter() - t0
        before = scrape_metrics(dm)
        texts = []
        for name in names[:8]:
            with open(os.path.join(files, name)) as f:
                texts.append(" ".join(f.read().split()[:24]))
        t1 = time.perf_counter()
        for name, q in zip(names, texts):
            code, hits = http_json(dm, "/api/query/hybrid",
                                   {"query": q, "k": 10})
            check(code == 200 and len(hits) == 10 and name in [
                h["metadata"]["display_name"] for h in hits],
                f"7f: the spawned data-manager's hybrid query for {name}")
        out["query_ms"] = (time.perf_counter() - t1) / len(texts) * 1e3
        t1 = time.perf_counter()
        for i, q in enumerate(texts[:4]):
            code, r = http_json(chat, "/api/get_chat_response",
                                {"message": q}, user=f"create{i}@smoke")
            check(code == 200 and r["sources"], f"7f: chat {code} {r}")
            code, hits = http_json(dm, "/api/query/hybrid", {
                "query": r["metadata"]["condensed_output"], "k": 5,
                "semantic_weight": 0.4, "bm25_weight": 0.6})
            want = as_sources([(Document(h["page_content"], h["metadata"]),
                                h["score"]) for h in hits])
            check(code == 200 and same_sources(r["sources"], want),
                  "7f: the spawned chat's sources differ from its "
                  "data-manager's hybrid search")
        out["chat_ms"] = (time.perf_counter() - t1) / 4 * 1e3
        after = scrape_metrics(dm)
        rose = after.get('archi_engine_queries_total{kind="hybrid"}', 0.0) \
            - before.get('archi_engine_queries_total{kind="hybrid"}', 0.0)
        fallbacks = sum(v for k, v in after.items()
                        if k.startswith("archi_fused_topk_fallbacks"))
        check(rose >= 12 and fallbacks == 0,
              f"7f: /metrics of the spawned data-manager: +{rose} hybrid "
              f"queries, {fallbacks} top-k fallbacks")
        status = mgr.status()
        check(set(status) == {"data_manager", "chat"}
              and all(s["alive"] for s in status.values()),
              f"7f: status {status}")
        t1 = time.perf_counter()
        mgr.delete()
        pids = [info["pid"] for info in started.values()]
        while len(reaped) < len(pids) and time.perf_counter() - t1 < 60:
            time.sleep(0.05)
        gone = []
        for pid in pids:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                gone.append(pid)
        out["delete_s"] = time.perf_counter() - t1
        check(len(gone) == len(pids) and not os.path.isdir(mgr.dir),
              f"7f: delete left {set(pids) - set(gone)} running")
        out.update(files=CREATE_FILES, hybrid_rose=rose,
                   exit_status=dict(reaped))
    except BaseException:
        for name in started:
            path = os.path.join(mgr.dir, f"{name}.log")
            if os.path.exists(path):
                with open(path) as f:
                    log(f"  7f: {name}.log:\n" + f.read()[-6000:])
        for info in started.values():
            try:
                os.kill(info["pid"], signal.SIGKILL)
            except OSError:
                pass
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  7f: create: the data-manager ready ({CREATE_FILES} files ingested) "
        f"{out['dm_ready_s']:.1f} s after the start, the chat "
        f"{out['chat_ready_s']:.1f} s; hybrid {out['query_ms']:.1f} ms and "
        f"chat {out['chat_ms']:.1f} ms a request over HTTP, 0 fallbacks; "
        f"delete stopped both in {out['delete_s']:.1f} s")
    return out


def entry_points(results, st, overrides, texts, vocab, corpus):
    """7f: the port's other entry points on 7d's live data-manager: the
    grader, the account tool, the bots and the ticket processor over 7d's
    store; the benchmark service and ``evaluate``; ``create`` and
    ``delete`` of a deployment.  → launches by part."""
    import importlib.util

    t_part = time.perf_counter()
    # create's deployments, read when cli/deployment.py is first imported
    os.environ["ARCHI_TPU_DEPLOYMENTS"] = os.path.join(
        SERVICE_TMP, "7f", "deployments")
    out = {"packages": {name: importlib.util.find_spec(name) is not None
                        for name in ("click", "yaml", "psycopg2",
                                     "selenium")}}
    log("  7f: packages on this machine: " + json.dumps(out["packages"]) +
        " (Postgres is held on the CPU only: no server here)")
    launches, routes, out["services"] = entry_services(
        st, overrides, texts, vocab)
    parts = {"entry_services": (launches, routes)}
    eval_parts, out["evaluate"] = entry_evaluate()
    parts.update(eval_parts)
    try:
        out["create"] = entry_create(corpus)
    finally:
        os.environ.pop("ARCHI_TPU_DEPLOYMENTS", None)
    out["seconds"] = time.perf_counter() - t_part
    results["service"]["entry_points"] = out
    log(f"  7f took {out['seconds']:.1f} s")
    return parts


# ------------------------------------------------------------------ phase 8
def query_views(rng, docs):
    """A keyword view of each document, as the trainer's ICT views are
    made: about 40% of its words in order, without the document's id."""
    views = []
    for d in docs:
        words = d.split()[1:]
        keep = rng.random(len(words)) < 0.4
        views.append(" ".join(w for w, k in zip(words, keep) if k))
    return views


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want|, of one tensor."""
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def attention_train_ms(config) -> float:
    """CUDA-event time of ``differentiable_attention``'s forward and
    backward at one training layer's shape (B=64, S=96, bf16)."""
    import torch

    from archi_tpu_torch.ops.attention import differentiable_attention

    b, s, nh = TRAIN_BATCH, TRAIN_SEQ, config.num_heads
    h = config.hidden_size
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    qkv = torch.randn(b, s, 3 * h, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_(True)
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, h // nh)
               for i in range(3))
    key_bias = torch.zeros(b, s, device="cuda")
    grad = torch.randn(b, s, nh, h // nh, device="cuda", generator=g).to(
        torch.bfloat16)

    def step():
        out = differentiable_attention(q, k, v, key_bias,
                                       sm_scale=(h // nh) ** -0.5)
        torch.autograd.grad(out, qkv, grad)
    return cuda_ms(step, iters=20, warmup=3)


def training(results, docs):
    """Phase 8: the trainer at MiniLM-L6's widths (H=384, 6 layers, 12
    heads, intermediate 1536) over phase 3's first 1024 documents, a
    corpus vocabulary of 8192, batch 64, seq_len 96, 100 steps, seed 0.
    → launches by part."""
    import dataclasses

    import numpy as np
    import torch

    from archi_tpu_torch import native
    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models import train_encoder as te
    from archi_tpu_torch.models.bert import BertConfig, BertEncoder, init_params
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.models.hf_loader import params_from_jax
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    texts = docs[:TRAIN_DOCS]
    config = dataclasses.replace(
        BertConfig.minilm_l6(), vocab_size=TRAIN_VOCAB,
        hidden_size=TRAIN_HIDDEN, num_layers=TRAIN_LAYERS,
        num_heads=TRAIN_HEADS, intermediate_size=4 * TRAIN_HIDDEN)
    out = {"config": dataclasses.asdict(config), "docs": len(texts),
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS}

    # ---- step 0 at f32: the card against the CPU on the same batch (the
    # comparison's launches are not the phase's)
    t0 = time.perf_counter()
    tok = WordPieceTokenizer.build_vocab(texts, size=TRAIN_VOCAB)
    check(tok.vocab_size <= TRAIN_VOCAB, "train: vocabulary too large")
    first = next(te.batches(texts, tok, np.random.default_rng(SEED),
                            steps=1, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    state = params_from_jax(init_params(config, seed=SEED))
    step0 = {}
    for dev in ("cpu", DEV):
        model = BertEncoder.for_training(config, state, device=dev,
                                         compute_dtype=torch.float32)
        loss = te.contrastive_loss(model, *te.to_batch(*first, device=dev),
                                   tau=0.05)
        loss.backward()
        step0[dev] = (loss.item(), {n: p.grad.detach().cpu()
                                    for n, p in model.named_parameters()})
        del model, loss
    (l_cpu, g_cpu), (l_dev, g_dev) = step0["cpu"], step0[DEV]
    out["step0_loss_f32"] = {"cpu": l_cpu, "card": l_dev}
    out["step0_loss_rel_err"] = abs(l_dev - l_cpu) / abs(l_cpu)
    out["step0_grad_max_rel_err"] = max(max_rel_err(g_dev[n], g_cpu[n])
                                        for n in g_cpu)
    out["step0_check_s"] = time.perf_counter() - t0
    del step0, g_cpu, g_dev, state
    log(f"  step 0 at f32: loss {l_dev:.6f} on the card, {l_cpu:.6f} on the "
        f"CPU (rel. err {out['step0_loss_rel_err']:.2e}); gradients within "
        f"{out['step0_grad_max_rel_err']:.2e} of the CPU's (relative to each "
        f"tensor's largest; limit 1e-4)")
    check(out["step0_loss_rel_err"] <= 1e-4
          and out["step0_grad_max_rel_err"] <= 1e-4,
          f"train: step 0 on the card differs from the CPU {out}")

    # ---- 100 steps in bf16, counted
    reset_launches()
    native.reset_routes()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stamps, losses = [], []

    def stamp(_line):
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    config, model, tok = te.train(
        texts, config=config, vocab_size=TRAIN_VOCAB, steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED, device=DEV,
        log_every=10, log=stamp, losses=losses)
    sync()
    out["train_s"] = time.perf_counter() - t0
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    text_routes = dict(native.ROUTES)
    # logs at steps 0, 10, ..., 90 and 99 (each reads the loss: a sync)
    out["steps_per_s"] = (TRAIN_STEPS - 1 - 10) / (stamps[-1] - stamps[1])
    out["peak_memory_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                              if DEV == "cuda" else None)
    out["loss_every_10"] = losses[::10] + [losses[-1]]
    first10, last10 = np.mean(losses[:10]), np.mean(losses[-10:])
    out["loss_first10_mean"], out["loss_last10_mean"] = first10, last10
    log(f"  {TRAIN_STEPS} bf16 steps in {out['train_s']:.1f} s "
        f"({out['steps_per_s']:.2f} steps/s from step 10 to 99), peak "
        f"memory {out['peak_memory_gib']} GiB; loss every 10 steps "
        f"{[round(x, 4) for x in out['loss_every_10']]}")
    log(f"  train launches {launches}, routes {routes}, text routes "
        f"{text_routes}")
    check(all(np.isfinite(losses)) and last10 < first10,
          f"train: the loss did not fall ({first10:.4f} -> {last10:.4f})")
    if DEV == "cuda":
        # attention's share of a step: its forward (the kernel) and its
        # backward (the plain version's autograd) at one layer's shape,
        # run 2 towers x 6 layers times a step
        out["attention_fwd_bwd_ms"] = attention_train_ms(config)
        out["attention_share_of_step"] = (
            2 * config.num_layers * out["attention_fwd_bwd_ms"]
            * out["steps_per_s"] / 1e3)
        log(f"  attention forward + backward at the step's shape "
            f"{out['attention_fwd_bwd_ms']:.3f} ms, "
            f"{out['attention_share_of_step']:.1%} of a step")
    check_routes("train", launches, routes, ("encoder_attention",))
    check_native_routes("train", text_routes)
    results["text_routes"]["train"] = text_routes
    parts = {"train": (launches, routes)}

    # ---- the export served: build_vectorstore over the snapshot
    shutil.rmtree(TRAIN_TMP, ignore_errors=True)
    model_dir = os.path.join(TRAIN_TMP, "model")
    te.save_model_dir(model_dir, config, model, tok)
    del model
    rng = np.random.default_rng(SEED + 8)
    probes = list(range(0, TRAIN_DOCS, TRAIN_DOCS // TRAIN_PROBES))
    views = query_views(rng, [texts[i] for i in probes])
    reset_launches()
    store = build_vectorstore(
        {"embedding_name": "minilm", "model_dir": model_dir,
         "data_path": os.path.join(TRAIN_TMP, "data"), "index": {}},
        device=DEV)
    check(store._embedding_function.config == config,
          "train: the snapshot loads another configuration")
    doc_ids = store.add_texts(texts)
    found = store.similarity_search_batch(views, k=10)
    sync()
    parts["train_store"] = (dict(LAUNCHES), dict(ROUTE_LAUNCHES))
    check_routes("train_store", *parts["train_store"])
    hits = [ids_of(r)[:1] == [doc_ids[i]] for r, i in zip(found, probes)]
    out["rank1_trained"] = float(np.mean(hits))
    # the same views through the untrained weights (training's start)
    untrained = TorchVectorStore(TorchEmbedder(
        config=config, tokenizer=tok, seed=SEED, device=DEV), device=DEV)
    base_ids = untrained.add_texts(texts)
    base = untrained.similarity_search_batch(views, k=10)
    out["rank1_untrained"] = float(np.mean(
        [ids_of(r)[:1] == [base_ids[i]] for r, i in zip(base, probes)]))
    log(f"  the export through build_vectorstore: {TRAIN_PROBES} query views "
        f"find their document at rank 1 {out['rank1_trained']:.3f} of the "
        f"time (untrained weights {out['rank1_untrained']:.3f}; limit 0.75)")
    check(out["rank1_trained"] >= 0.75,
          f"train: rank-1 {out['rank1_trained']:.3f} < 0.75")
    shutil.rmtree(TRAIN_TMP, ignore_errors=True)
    results["train"] = out
    log("  " + json.dumps(out))
    return parts


# ------------------------------------------------------------------ phase 9
def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def shard_flat(results):
    """9a: ``ShardedFlatIndex`` with SHARDS logical shards on the card
    against one ``FlatIndex`` over the same 2^22 rows (blocks across the
    seams), tombstones and a filter; searches at B=32 and B=256 (shared
    bias) and B=32 (per-query bias), then growth past the capacity.
    → (launches by part, the sharded index and 9b's calls with their
    results)."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex, _merge
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = {"shards": SHARDS, "rows": SHARD_ROWS}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)

    def unit_rows(n):
        return torch.nn.functional.normalize(
            torch.randn(n, 384, device=DEV, generator=gen), dim=1)

    sharded = ShardedFlatIndex(384, devices=[DEV] * SHARDS)
    flat = FlatIndex(384, device=DEV)
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t_sharded = t_flat = 0.0
    for s0 in range(0, SHARD_ROWS, SHARD_BLOCK):
        x = unit_rows(min(SHARD_BLOCK, SHARD_ROWS - s0))
        ids = list(range(s0, s0 + x.shape[0]))
        sync()
        t0 = time.perf_counter()
        sharded.add(x, ids)
        sync()
        t_sharded += time.perf_counter() - t0
        t0 = time.perf_counter()
        flat.add(x, ids)
        sync()
        t_flat += time.perf_counter() - t0
    del x
    check(sharded.capacity == flat.capacity == SHARD_ROWS
          and sharded.shard_cap == SHARD_ROWS // SHARDS
          and sharded.n_rows == flat.n_rows == SHARD_ROWS,
          f"9a: capacities {sharded.capacity} / {flat.capacity}")
    out.update(fill_s_sharded=t_sharded, fill_s_flat=t_flat,
               shard_cap=sharded.shard_cap)
    rng = np.random.default_rng(SEED + 21)
    dead = rng.choice(SHARD_ROWS, 4096, replace=False).tolist()
    check(sharded.delete(dead) == flat.delete(dead) == 4096, "9a: deletes")
    fm = torch.from_numpy((rng.random(SHARD_ROWS) > 0.05).astype(
        np.float32)).to(DEV)
    stored = torch.arange(7, SHARD_ROWS, SHARD_ROWS // 16, device=DEV)
    emb_rows = flat.emb[stored].float()
    q32 = torch.cat([emb_rows, unit_rows(16)])
    q256 = torch.cat([emb_rows, unit_rows(240)])
    bias = 0.1 * torch.rand(32, SHARD_ROWS, device=DEV, generator=gen)
    calls = [("b32_shared", q32, {"filter_mask": fm}),
             ("b256_shared", q256, {"filter_mask": fm}),
             ("b32_per_query", q32, {"bias": bias, "filter_mask": fm})]

    stored_np, fm_np = stored.cpu().numpy(), fm.cpu().numpy()

    def compare(part):
        """Every call on both indexes: scores within 1e-6, rows tie-aware;
        stored rows (neither deleted nor filtered) at rank 1."""
        res = {}
        for name, q, kw in calls:
            got = sharded.search(q, k=10, **kw)
            want = flat.search(q, k=10, **kw)
            check(same_rows(got[1], got[2], want[1], want[2], tol=1e-6),
                  f"{part}: sharded and flat differ ({name})")
            out[f"{part}_{name}_max_abs_err"] = float(
                np.abs(got[1] - want[1]).max())
            res[name] = got
        top = res["b32_shared"][2][:16, 0]
        hidden = np.isin(stored_np, dead) | (fm_np[stored_np] == 0)
        check(bool(((top == stored_np) | hidden).all()),
              f"{part}: stored rows miss rank 1")
        return res

    before = compare("9a")
    for name, q, kw in calls:
        out[f"search_ms_sharded_{name}"] = cuda_ms(
            lambda: sharded.search_dispatch(q, k=10, **kw), iters=5)
        out[f"search_ms_flat_{name}"] = cuda_ms(
            lambda: flat.search_dispatch(q, k=10, **kw), iters=5)
    for b in (32, 256):
        v = torch.rand(b, SHARDS * 10, device=DEV, generator=gen)
        r = torch.arange(SHARDS * 10, device=DEV).repeat(b, 1)
        out[f"merge_ms_b{b}"] = cuda_ms(lambda: _merge(v, r, 10))
    log(f"  9a: {SHARD_ROWS} rows in {SHARDS} shards of {sharded.shard_cap} "
        f"(fill {t_sharded:.1f} s, one index {t_flat:.1f} s); B=32 "
        f"{out['search_ms_sharded_b32_shared']:.3f} ms sharded, "
        f"{out['search_ms_flat_b32_shared']:.3f} ms one index; B=256 "
        f"{out['search_ms_sharded_b256_shared']:.3f} / "
        f"{out['search_ms_flat_b256_shared']:.3f}; per-query bias "
        f"{out['search_ms_sharded_b32_per_query']:.3f} / "
        f"{out['search_ms_flat_b32_per_query']:.3f}; the merge "
        f"{out['merge_ms_b32']:.4f} ms at B=32 ({card_line()})")

    # ---- growth: rows move shard
    x = unit_rows(SHARD_GROW)
    ids = list(range(SHARD_ROWS, SHARD_ROWS + SHARD_GROW))
    sync()
    t0 = time.perf_counter()
    sharded.add(x, ids)
    sync()
    out["grow_s_sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat.add(x, ids)
    sync()
    out["grow_s_flat"] = time.perf_counter() - t0
    check(sharded.capacity == flat.capacity == 2 * SHARD_ROWS
          and sharded.shard_cap == 2 * SHARD_ROWS // SHARDS,
          "9a: growth capacities")
    fm = torch.cat([fm, torch.ones(SHARD_GROW, device=DEV)])
    bias = torch.cat([bias, torch.zeros(32, SHARD_GROW, device=DEV)], dim=1)
    q32 = torch.cat([q32[:24], x[:8]])
    calls = [("b32_shared", q32, {"filter_mask": fm}),
             ("b32_per_query", q32, {"bias": bias, "filter_mask": fm})]
    after = compare("9a_grown")
    fresh_top = after["b32_shared"][2][24:, 0]
    check(bool((fresh_top == np.arange(SHARD_ROWS, SHARD_ROWS + 8)).all()),
          "9a: rows added after growth miss rank 1")
    for name, q, kw in calls:
        out[f"grown_search_ms_sharded_{name}"] = cuda_ms(
            lambda: sharded.search_dispatch(q, k=10, **kw), iters=5)
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("9a", launches, routes, ("fused_topk",))
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "9a: top-k fell back")
    log(f"  9a ({results['card']}): grew to {sharded.capacity} "
        f"({sharded.shard_cap} a shard) in "
        f"{out['grow_s_sharded']:.2f} s (one index {out['grow_s_flat']:.2f} "
        f"s); searches equal the one index's (max err "
        f"{max(v for k, v in out.items() if k.endswith('max_abs_err')):.3g}"
        f"); {launches['fused_topk']} top-k launches, all on the tensor "
        f"cores")
    del flat
    results["shards"] = {"flat": out}
    return {"shard_flat": (launches, routes)}, sharded, calls, after


def shard_nccl(results, sharded, calls, want):
    """9b: a one-rank NCCL group (``initialize_distributed`` from
    COORDINATOR_ADDRESS): 9a's searches go through ``all_gather`` and equal
    9a's results bit for bit."""
    import numpy as np
    import torch.distributed as dist

    from archi_tpu_torch.engine import distributed, sharded_index
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    gathered = []
    real = sharded_index.all_gather

    def counted(t, group):
        gathered.append(tuple(t.shape))
        return real(t, group)

    os.environ["COORDINATOR_ADDRESS"] = f"127.0.0.1:{free_port()}"
    sharded_index.all_gather = counted
    reset_launches()
    try:
        t0 = time.perf_counter()
        distributed.initialize_distributed()
        init_s = time.perf_counter() - t0
        try:
            check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                  "9b: not a one-rank NCCL group")
            got = {name: sharded.search(q, k=10, **kw)
                   for name, q, kw in calls}
            q, kw = calls[0][1], calls[0][2]
            ms = cuda_ms(lambda: sharded.search_dispatch(q, k=10, **kw),
                         iters=5)
        finally:
            dist.destroy_process_group()
    finally:
        sharded_index.all_gather = real
        del os.environ["COORDINATOR_ADDRESS"]
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check(len(gathered) >= 2 * len(calls), "9b: no all_gather ran")
    for name, (gi, gv, gr) in got.items():
        wi, wv, wr = want[name]
        check(gi == wi and np.array_equal(gv, wv) and np.array_equal(gr, wr),
              f"9b: {name} through the group differs from 9a")
    check_routes("9b", launches, routes, ("fused_topk",))
    results["shards"]["nccl"] = {"init_s": init_s, "all_gathers":
                                 len(gathered), "search_ms_b32_shared": ms}
    log(f"  9b: one-rank NCCL group up in {init_s:.2f} s; {len(got)} "
        f"searches through {len(gathered)} all_gathers equal 9a's bit for "
        f"bit; B=32 {ms:.3f} ms through the group ({results['card']})")
    return {"shard_nccl": (launches, routes)}


def shard_ivf(results):
    """9c: ``ShardedIVFIndex`` and ``ShardedIVFPQIndex`` built over 2^22
    clustered rows (phase 5's generator and seed) in SHARDS shards on the
    card, at path A's parameters (IVF-PQ candidates rescored exactly, 4 x k,
    by a host tier); recall@10 against the exact scan."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.host_store import HostVectorStore
    from archi_tpu_torch.engine.sharded_ivf import ShardedIVFIndex
    from archi_tpu_torch.engine.sharded_ivfpq import ShardedIVFPQIndex
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = {}
    corpus = ClusteredRows(PATH_ROWS, SEED + 6)
    x = torch.cat([corpus.rows(FILL_BATCH)
                   for _ in range(PATH_ROWS // FILL_BATCH)])
    q = corpus.rows(32)
    exact = exact_scan(x, PATH_ROWS, q)[1]
    t0 = time.perf_counter()
    xh = x.cpu().numpy()
    # the rows of the exact rerank tier, f16 as path B's host store holds
    # them (a same-type add is one copy)
    x16 = x.half().cpu().numpy()
    out["to_host_s"] = time.perf_counter() - t0
    del x
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    ivf = ShardedIVFIndex.build(xh, range(PATH_ROWS), devices=[DEV] * SHARDS,
                                nlist=1024, block=512)
    sync()
    out["ivf_build_s"] = time.perf_counter() - t0
    rows = ivf.search(q, k=10, nprobe=64)[2]
    out["ivf_recall_at_10"] = recall_at_10(rows, exact)
    out["ivf_search_ms_b32"] = host_ms(lambda: ivf.search(q, k=10, nprobe=64))
    del ivf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pq = ShardedIVFPQIndex.build(xh, None, devices=[DEV] * SHARDS,
                                 nlist=1024, block=512, m=48, refine_m=48)
    sync()
    out["ivfpq_build_s"] = time.perf_counter() - t0
    del xh
    # path A rescores rerank_overfetch (4) x k ADC candidates exactly; here
    # the host tier does it (config 4's shape), by global row
    t0 = time.perf_counter()
    plane = HostVectorStore(384, capacity=PATH_ROWS)
    plane.add(x16)
    out["rerank_plane_s"] = time.perf_counter() - t0
    del x16
    rows = pq.search(q, k=10, nprobe=64, rerank_store=plane)[2]
    out["ivfpq_recall_at_10"] = recall_at_10(rows, exact)
    # the ADC and its refinement alone, without the exact tier (a reading:
    # 64 near-duplicates a cluster are within the PQ error of each other)
    rows = pq.search(q, k=10, nprobe=64)[2]
    out["ivfpq_adc_only_recall_at_10"] = recall_at_10(rows, exact)
    out["ivfpq_search_ms_b32"] = host_ms(
        lambda: pq.search(q, k=10, nprobe=64, rerank_store=plane))
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    max_bpc = max(int(s.cell_blocks.shape[1]) for s in pq.shards)
    out["max_bpc"] = max_bpc
    log(f"  9c: {PATH_ROWS} clustered rows in {SHARDS} shards: IVF built in "
        f"{out['ivf_build_s']:.1f} s, recall@10 "
        f"{out['ivf_recall_at_10']:.3f}, B=32 {out['ivf_search_ms_b32']:.1f} "
        f"ms; IVF-PQ built in {out['ivfpq_build_s']:.1f} s, recall@10 "
        f"{out['ivfpq_recall_at_10']:.3f} with the host rerank "
        f"({out['ivfpq_adc_only_recall_at_10']:.3f} without), B=32 "
        f"{out['ivfpq_search_ms_b32']:.1f} ms (host clock); "
        f"{launches['adc_scores']} ADC launches ({results['card']})")
    check_routes("9c", launches, routes, ("adc_scores",))
    # limits: path A's (the same corpus and parameters on one index)
    check(out["ivf_recall_at_10"] >= 0.6 and out["ivfpq_recall_at_10"] >= 0.6,
          f"9c: recall@10 {out['ivf_recall_at_10']:.3f} / "
          f"{out['ivfpq_recall_at_10']:.3f} < 0.6")
    del pq, plane
    torch.cuda.empty_cache()
    # the 8-bit kernel against its plain version at a shard's probe shape
    # (one query a group over 64 cells of up to max_bpc blocks of 512)
    results["adc_scores"].append(adc_case(
        f"adc8_g1_m48_s{64 * max_bpc * 512}_shard", 48, 1,
        64 * max_bpc * 512, False, timed=True))
    results["shards"]["ivf"] = out
    return {"shard_ivf": (launches, routes)}


def shard_xl(results, emb, vocab):
    """9d: ``type: ivfpq_xl_sharded`` at the bootstrap's defaults through
    ``build_vectorstore`` on SHARDS shards of the card: 2^20 clustered rows
    through ``add_texts``, documents in a fresh tail, 64 clients x 8
    micro-batched hybrid requests against the direct path, recall, exact
    scores, the profile split, save/load and ``adopt_stores`` over
    ``HostVectorStore.view`` windows."""
    import numpy as np
    import torch

    from archi_tpu_torch.bin.bootstrap import build_vectorstore
    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.engine.host_store import BF16, HostVectorStore
    from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
    from archi_tpu_torch.models.train_encoder import save_model_dir
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    out = {}
    model_dir = os.path.join(SHARD_TMP, "model")
    save_model_dir(model_dir, emb.config, emb.model, emb.tokenizer)
    dm = {"embedding_name": "minilm", "model_dir": model_dir,
          "data_path": os.path.join(SHARD_TMP, "xl", "data"),
          "index": {"type": "ivfpq_xl_sharded",
                    "store_dir": os.path.join(SHARD_TMP, "xl", "planes")},
          "serving": {"micro_batch": {"enabled": True}}}
    st = build_vectorstore(dm, devices=[DEV] * SHARDS)
    idx = st.index
    check(isinstance(idx, ShardedXlPQIndex) and idx.n_shards == SHARDS
          and all((s.nlist, s.block, s.pq_m, s.pq_refine_m, s.ksub,
                   s.nprobe_blocks, s.min_snapshot_rows, s.build_block_rows,
                   s.rerank_overfetch, s.async_refresh)
                  == (4096, 512, 48, 48, 16, 128, 1 << 17, 1 << 17, 16,
                      False) for s in idx.shards),
          "9d: not a sharded XL tier at the bootstrap's defaults")
    rng = np.random.default_rng(SEED + 9)
    corpus = ClusteredRows(XL_ROWS, SEED + 10, d=idx.dim)
    fill = synthetic_texts(rng, vocab, XL_ROWS, 3)

    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    for s0 in range(0, XL_ROWS, FILL_BATCH):
        chunk = fill[s0:s0 + FILL_BATCH]
        st.add_texts(chunk, embeddings=corpus.rows(len(chunk)))
    out["fill_s"] = time.perf_counter() - t0
    per = XL_ROWS // SHARDS
    check([(s.n_rows, s._n_snap) for s in idx.shards] == [(per, per)] * SHARDS
          and all(s.refresh_failures == 0 for s in idx.shards),
          "9d: shards not balanced, or a snapshot missing")
    xl_docs = synthetic_texts(rng, vocab, SHARD_DOCS, 96, prefix="sx")
    t0 = time.perf_counter()
    doc_ids = st.add_texts(xl_docs)
    out["ingest_s"] = time.perf_counter() - t0
    check(sum(len(s.tail) for s in idx.shards) == SHARD_DOCS,
          "9d: documents not in a fresh tail")
    log(f"  9d ({results['card']}): filled {XL_ROWS} rows into {SHARDS} "
        f"shards in "
        f"{out['fill_s']:.1f} s (every shard's snapshot {per} rows), "
        f"{SHARD_DOCS} documents into a tail in {out['ingest_s']:.1f} s")

    probe = rng.choice(SHARD_DOCS, SVC_CLIENTS * 4, replace=False)
    reqs = [[("hybrid", xl_docs[probe[c * 4 + j]]) for j in range(4)]
            + [("hybrid", short_query(rng, vocab)) for _ in range(4)]
            for c in range(SVC_CLIENTS)]
    got, lat, wall = run_clients(st, reqs)
    t0 = time.perf_counter()
    want = {(c, j): st._hybrid_search_impl(q, k=10)
            for c in range(SVC_CLIENTS) for j, (_k, q) in enumerate(reqs[c])}
    seq_wall = time.perf_counter() - t0
    bad = [key for key, w in want.items() if not same_ranking(got[key], w)]
    check(not bad, f"9d: micro-batched results differ from the direct path "
                   f"at {bad[:8]}")
    miss = [c for c in range(SVC_CLIENTS) for j in range(4)
            if ids_of(got[(c, j)])[:1] != [doc_ids[probe[c * 4 + j]]]]
    check(not miss, f"9d: documents miss rank 1 ({len(miss)})")
    out.update(requests=len(got), qps_micro_batched=len(got) / wall,
               qps_request_at_a_time=len(got) / seq_wall, **latency_ms(lat))

    # recall@10 and exact scores against the shards' host rows
    qv = corpus.rows(32)
    ids, vals, rows = idx.search(qv, k=10)
    plane = torch.empty((idx.n_rows, idx.dim), dtype=torch.bfloat16,
                        device=DEV)
    for s, shard in enumerate(idx.shards):
        g = torch.from_numpy(idx._global_rows(s)).to(DEV)
        raw = np.array(shard.store._buf[:shard.n_rows]).view(np.int16)
        plane[g] = torch.from_numpy(raw).to(DEV).view(torch.bfloat16)
    exact = exact_scan(plane, idx.n_rows, qv)[1]
    out["recall_at_10"] = recall_at_10(rows, exact)
    qn = torch.nn.functional.normalize(qv, dim=1)
    got_s = torch.from_numpy(vals).to(DEV)
    prod = (plane[torch.from_numpy(rows).to(DEV)].float()
            * qn[:, None, :]).sum(-1)
    out["score_max_abs_err_vs_plane"] = float((got_s - prod).abs().max())
    del plane, prod
    check(out["recall_at_10"] >= 0.9,
          f"9d: recall@10 {out['recall_at_10']:.3f} < 0.9")
    check(out["score_max_abs_err_vs_plane"] <= 1e-4,
          f"9d: scores off the exact products by "
          f"{out['score_max_abs_err_vs_plane']:.3g}")
    prof = {}
    idx.search(qv, k=10, profile=prof)
    out["profile_b32"] = prof
    out["search_ms_b32"] = host_ms(lambda: idx.search(qv, k=10))
    sync()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("9d", launches, routes,
                 ("fused_topk", "encoder_attention", "adc_scores_lut16"))
    check(engine_topk.FUSED_FALLBACKS["count"] == 0, "9d: top-k fell back")
    st._batcher.close()

    # save/load round trip
    path = os.path.join(SHARD_TMP, "xl", "ckpt", "index.npz")
    t0 = time.perf_counter()
    idx.save(path)
    loaded = ShardedXlPQIndex.load(path, devices=[DEV] * SHARDS)
    out["save_load_s"] = time.perf_counter() - t0
    after = loaded.search(qv, k=10)
    check(after[0] == ids and np.array_equal(after[1], vals),
          "9d: the save/load round trip changed the results")
    del loaded

    # adopt_stores over views of one plane that holds the shards' rows
    # shard-major: the adopted tier answers as the one filled by add()
    t0 = time.perf_counter()
    big = HostVectorStore(idx.dim, capacity=idx.n_rows, dtype=BF16)
    for shard in idx.shards:
        big.add(shard.store.to_f32(shard.store._buf[:shard.n_rows]))
    bounds = np.cumsum([0] + [s.n_rows for s in idx.shards])
    views = [HostVectorStore.view(big, int(lo), int(hi))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    s0 = idx.shards[0]
    adopted = ShardedXlPQIndex(
        idx.dim, devices=[DEV] * SHARDS, stores=views, normalize=False,
        nlist=s0.nlist, block=s0.block, pq_m=s0.pq_m,
        pq_refine_m=s0.pq_refine_m, nprobe_blocks=s0.nprobe_blocks,
        rerank_overfetch=s0.rerank_overfetch,
        min_snapshot_rows=s0.min_snapshot_rows,
        build_block_rows=s0.build_block_rows)
    adopted.adopt_stores([s._ids for s in idx.shards])
    sync()
    out["adopt_s"] = time.perf_counter() - t0
    # every block probed: both tiers return the exact top-10 of their
    # candidates, independent of the k-means' float atomics
    full = max(int(s._ivf.code_blocks.shape[0]) for s in adopted.shards)
    a_ids, a_vals, _ = adopted.search(qv, k=10, nprobe_blocks=full)
    f_ids, f_vals, _ = idx.search(qv, k=10, nprobe_blocks=full)
    check(a_ids == f_ids and np.abs(a_vals - f_vals).max() <= 1e-6,
          "9d: the adopted tier differs from the one filled by add()")
    d_ids = adopted.search(qv, k=10)[0]
    out["adopt_top10_agreement_default_probe"] = float(np.mean(
        [len(set(a) & set(b)) / 10 for a, b in zip(d_ids, ids)]))
    del adopted, views, big
    results["shards"]["xl"] = out
    log(f"  9d ({results['card']}): " + json.dumps(out))
    return {"shard_xl": (launches, routes)}


def shard_encode(results, emb, docs):
    """9e: ``TorchEmbedder(devices=[DEV] * 2)``, the data-parallel encode,
    over phase 3's first documents against the single-device embedder."""
    import numpy as np

    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    texts = docs[:SHARD_DOCS]
    dp = TorchEmbedder(config=BertConfig.minilm_l6(), tokenizer=emb.tokenizer,
                       seed=SEED, devices=[DEV] * 2)
    reset_launches()
    t0 = time.perf_counter()
    a = dp.encode_numpy(texts)
    sync()
    dp_s = time.perf_counter() - t0
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    check_routes("9e", launches, routes, ("encoder_attention",))
    t0 = time.perf_counter()
    b = emb.encode_numpy(texts)
    sync()
    one_s = time.perf_counter() - t0
    cos = float(np.min(np.sum(a * b, axis=1) / (
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))))
    check(np.isfinite(a).all() and a.shape == b.shape and cos >= 0.9999,
          f"9e: data-parallel encode against one device: min cosine {cos}")
    results["shards"]["encode"] = {"docs": len(texts), "min_cosine": cos,
                                   "split_s": dp_s, "one_device_s": one_s}
    log(f"  9e: {len(texts)} documents encoded in two halves a batch in "
        f"{dp_s:.2f} s (one device {one_s:.2f} s); min cosine {cos:.6f} "
        f"(limit 0.9999; {results['card']})")
    return {"shard_encode": (launches, routes)}


def multi_device(results, emb, docs, vocab):
    """Phase 9, parts 9a-9e; each part runs with the counts set to 0 just
    before it.  → launches by part."""
    import torch

    shutil.rmtree(SHARD_TMP, ignore_errors=True)
    parts, sharded, calls, after = shard_flat(results)
    parts.update(shard_nccl(results, sharded, calls, after))
    del sharded, calls, after
    torch.cuda.empty_cache()
    parts.update(shard_ivf(results))
    parts.update(shard_xl(results, emb, vocab))
    torch.cuda.empty_cache()
    parts.update(shard_encode(results, emb, docs))
    return parts


# ----------------------------------------------------------------- phase 10
def counted(part: str, names, run, shapes=None):
    """Run ``run()`` with the launch and fallback counts set to 0 just
    before it; every named kernel must have launched, each launch on its
    fast route, and no top-k may have fallen back.  With ``shapes`` (a
    ``KernelShapes``, entered around the run) a top-k over an f32 corpus is
    planned for the CUDA-core kernel and one over bf16 or int8 for the
    tensor cores, and each must have taken its plan.  → (run's result,
    {part: (launches, routes)}, seconds, peak device GiB)."""
    import contextlib

    import torch

    from archi_tpu_torch.engine import topk as engine_topk
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES, reset_launches

    on_card = DEV == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    engine_topk.FUSED_FALLBACKS["count"] = 0
    reset_launches()
    t0 = time.perf_counter()
    with shapes if shapes is not None else contextlib.nullcontext():
        out = run()
        sync()
    seconds = time.perf_counter() - t0
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    if shapes is None:
        check_routes(part, launches, routes, names)
    else:
        check_planned_routes(part, launches, routes, names, shapes)
    check(engine_topk.FUSED_FALLBACKS["count"] == 0,
          f"{part}: top-k fell back")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    return out, {part: (launches, routes)}, seconds, peak


def config3(results):
    """10a: ``scripts/torch_run_config3.run`` at full size, then one B=32
    batch against a chunked f32 exact scan of the same tensor."""
    import torch

    from archi_tpu_torch.engine.topk import topk_scores
    from scripts import torch_run_config3 as cfg3

    check(cfg3.ROWS == CFG3_ROWS, "10a: config 3's row count moved")
    (payload, corpus), parts, secs, peak = counted(
        "config3", ("fused_topk",),
        lambda: cfg3.measure(rows=CFG3_ROWS, device=DEV))
    check(payload["rows"] == CFG3_ROWS and payload["dim"] == 768
          and tuple(corpus.shape) == (CFG3_ROWS, 768)
          and corpus.dtype == torch.bfloat16, "10a: not config 3's shape")
    check(payload["self_recall_top1"] == 1.0,
          f"10a: self_recall_top1 {payload['self_recall_top1']}")
    g = torch.Generator(device=DEV).manual_seed(SEED + 31)
    q = torch.nn.functional.normalize(
        torch.randn(32, 768, device=DEV, generator=g), dim=1)
    n = CFG3_ROWS
    vals, rows = topk_scores(q, corpus, torch.zeros(n, device=DEV), n, k=10)
    # the kernel rounds the queries to the corpus's bf16
    want_v, want_r = exact_scan(corpus, n, q.bfloat16().float())
    check(same_rows(vals.cpu().numpy(), rows.cpu().numpy(), want_v, want_r,
                    tol=1e-4), "10a: the scan differs from the exact scan")
    del corpus
    torch.cuda.empty_cache()
    out = dict(payload, seconds=secs, peak_gib=peak)
    results["baseline"]["config3"] = out
    log("  10a: " + json.dumps(out))
    return parts


def config5_vector(results):
    """10b: config 5's phase A at 8M rows for STREAM_SECONDS: the ingest
    rate, no growth, every streamed batch read back at rank 1, and the
    read-back and a fresh B=32 batch equal to an exact scan."""
    import torch

    from archi_tpu_torch.engine.flat_index import l2_normalize
    from archi_tpu_torch.engine.topk import alive_to_bias
    from scripts import torch_bench_streaming_ingest as cfg5

    check(cfg5.CAP == CFG5_CAP, "10b: config 5's capacity moved")
    (payload, state), parts, secs, peak = counted(
        "config5_vector", ("fused_topk",),
        lambda: cfg5.vector_stream(STREAM_SECONDS, device=DEV, cap=cfg5.CAP))
    idx, streamed = state["index"], state["streamed"]
    check(payload["ingest_rows_per_min"] >= 10_000,
          f"10b: ingest {payload['ingest_rows_per_min']} rows/min < 10,000")
    check(idx.capacity == cfg5.CAP,
          f"10b: the capacity moved to {idx.capacity} during the stream")
    n_pre = cfg5.CAP - cfg5.CAP // 64
    check(streamed and len(idx) == n_pre + 1024 * len(streamed)
          and payload["corpus_rows"] == len(idx),
          f"10b: {len(idx)} rows after {len(streamed)} streamed batches")
    check(len(streamed) in (STREAM_SECONDS // 2, STREAM_SECONDS // 2 + 1),
          f"10b: {len(streamed)} streamed batches, a read-back shape phase "
          f"2 does not hold")
    # an acknowledged write is read back: one row of every batch, at rank 1
    want = [row for row, _v in streamed]
    reads = torch.stack([v for _r, v in streamed])
    _ids, _vals, top = idx.search(reads, k=10)
    check(top[:, 0].tolist() == want, "10b: a streamed row is not at rank 1")
    # every row's score, not only the streamed one's: the index's queries
    # are normalised and the kernel rounds them to the corpus's bf16
    g = torch.Generator(device=DEV).manual_seed(SEED + 41)
    fresh = torch.randn(32, 384, device=DEV, generator=g)
    with idx._buf_lock:
        emb, alive, n_rows = idx.emb, idx.alive, idx.n_rows
    bias = alive_to_bias(alive)
    for what, q in (("the read-back", reads), ("a fresh batch", fresh)):
        _ids, vals, top = idx.search(q, k=10)
        want_v, want_r = exact_scan(emb, n_rows,
                                    l2_normalize(q).bfloat16().float(),
                                    bias=bias)
        check(same_rows(vals, top, want_v, want_r, tol=1e-4),
              f"10b: {what} differs from the exact scan")
    del idx, state, emb, alive, bias
    torch.cuda.empty_cache()
    out = dict(payload, batches=len(streamed), seconds=secs, peak_gib=peak)
    results["baseline"]["config5_vector"] = out
    log("  10b: " + json.dumps(out))
    return parts


def config5_hybrid(results):
    """10c: config 5's phase B at 2^20 rows for STREAM_SECONDS: no full BM25
    build during the stream, a final hybrid query equal to a brute-force
    scan, every text through the native analyzer."""
    import torch

    from archi_tpu_torch import native
    from archi_tpu_torch.engine.topk import alive_to_bias
    from scripts import torch_bench_streaming_ingest as cfg5

    native.reset_routes()
    (payload, state), parts, secs, peak = counted(
        "config5_hybrid", ("fused_topk",),
        lambda: cfg5.hybrid_stream(STREAM_SECONDS, device=DEV,
                                   rows=cfg5.HYBRID_ROWS,
                                   bm25_docs=cfg5.BM25_DOCS))
    check_native_routes("10c", dict(native.ROUTES))
    check(payload["bm25_full_builds_during_stream"] == 0,
          f"10c: {payload['bm25_full_builds_during_stream']} full BM25 "
          f"builds during the stream")
    check(payload["bm25_docs"] == cfg5.BM25_DOCS + payload["corpus_rows"]
          - cfg5.HYBRID_ROWS, "10c: a streamed text is not in BM25")
    idx, bm25, query = state["index"], state["bm25"], state["query"]
    g = torch.Generator(device=DEV).manual_seed(SEED + 51)
    qv = torch.randn(32, 384, device=DEV, generator=g)
    qtext = "term1 term7 term42 term4999"
    vals, rows = query(qv, qtext)
    with idx._buf_lock:
        emb, alive, cap, n_rows = idx.emb, idx.alive, idx.capacity, idx.n_rows
    bias = alive_to_bias(alive) + 0.6 * bm25.scores(qtext, cap)
    # the kernel rounds the (scaled) queries to the corpus's bf16
    want_v, want_r = exact_scan(emb, n_rows, (0.4 * qv).bfloat16().float(),
                                bias=bias)
    check(same_rows(vals.cpu().numpy(), rows.cpu().numpy(), want_v, want_r,
                    tol=1e-4), "10c: the hybrid query differs from brute force")
    del idx, bm25, query, state, emb, alive, bias
    torch.cuda.empty_cache()
    out = dict(payload, seconds=secs, peak_gib=peak)
    results["baseline"]["config5_hybrid"] = out
    log("  10c: " + json.dumps(out))
    return parts


def sweeps(results):
    """10d: ``run_sweep`` on the card over PATH_ROWS rows, its ground truth
    held against an f32 exact scan, a full probe read with the JAX tool's
    f32 queries; ``run_pq_sweep`` (IVF-PQ, flat PQ, the fixture's
    embeddings)."""
    import torch

    from archi_tpu_torch.benchmarking.ivf_sweep import run_sweep
    from archi_tpu_torch.benchmarking.pq_sweep import (fixture_embeddings,
                                                       run_pq_sweep)

    def allocated():
        return torch.cuda.memory_allocated() if DEV == "cuda" else 0

    before = allocated()
    ivf, parts, secs, peak = counted(
        "sweep_ivf", ("fused_topk",),
        lambda: run_sweep(PATH_ROWS, 384, nlist=SWEEP_NLIST,
                          nprobes=SWEEP_NPROBES, on_device=True, device=DEV))
    torch.cuda.empty_cache()
    left = (allocated() - before) / 2 ** 20
    check(left < 64, f"10d: the sweep left {left:.0f} MiB on the card")
    recall = [e["recall"] for e in ivf]
    check(all(a <= b for a, b in zip(recall, recall[1:])),
          f"10d: IVF recall falls with nprobe {recall}")
    check(ivf[-1]["nprobe"] == SWEEP_NLIST and recall[-1] == 1.0,
          f"10d: a full probe's recall is {recall[-1]}, not 1.0")
    out = {"ivf": ivf, "ivf_seconds": secs, "ivf_peak_gib": peak,
           "left_mib": left, "full_probe_recall_f32_queries":
           sweep_inputs_held()}

    def pq_sweeps():
        return {
            "ivfpq": run_pq_sweep(PQ_SWEEP_ROWS, 384, m=48, nlist=512,
                                  nprobes=(4, 16, 64), device=DEV),
            "pq_flat": run_pq_sweep(PQ_SWEEP_ROWS, 384, m=48, flat=True,
                                    device=DEV),
            "ivfpq_fixture": run_pq_sweep(m=48, nlist=512,
                                          nprobes=(4, 16, 64),
                                          corpus=fixture_embeddings(),
                                          device=DEV)}

    pq, pq_parts, secs, peak = counted("sweep_pq", ("adc_scores",),
                                       pq_sweeps)
    bad = [e for entries in pq.values() for e in entries
           if e["recall_in_100"] < e["recall_strict"] - 1e-9]
    check(not bad, f"10d: recall_in_100 below recall_strict {bad}")
    parts.update(pq_parts)
    out.update(pq, pq_seconds=secs, pq_peak_gib=peak)
    results["baseline"]["sweeps"] = out
    log("  10d: " + json.dumps(out))
    return parts


def sweep_inputs_held() -> float:
    """10d's inputs again (the corpus and the queries are pure in the
    seed): the sweep's ground truth (the kernel over the bf16-rounded
    queries) must equal an f32 exact scan, and a full probe with the
    unrounded f32 queries the JAX tool searches with must equal the exact
    scan of those queries.  → that full probe's recall against the
    ground truth, the recall the JAX tool's inputs would read."""
    import torch

    from archi_tpu_torch.benchmarking.ivf_sweep import (
        device_queries, synthetic_corpus_device)
    from archi_tpu_torch.engine.ivf_index import IVFIndex
    from archi_tpu_torch.engine.topk import topk_scores

    n = PATH_ROWS
    x = synthetic_corpus_device(n, 384, seed=0, device=DEV)
    q32 = torch.as_tensor(device_queries(x, 64, seed=0), device=DEV)
    qb = q32.bfloat16().float()
    vals, rows = topk_scores(qb, x, torch.zeros(n, device=DEV), n, k=10)
    vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
    check(same_rows(vals, rows, *exact_scan(x, n, qb), tol=1e-4),
          "10d: the sweep's ground truth differs from the exact scan")
    ivf = IVFIndex.build_device(x, nlist=SWEEP_NLIST, block=512, iters=10,
                                seed=0)
    _ids, f_vals, f_rows = ivf.search(q32.cpu().numpy(), k=10,
                                      nprobe=SWEEP_NLIST)
    check(same_rows(f_vals, f_rows, *exact_scan(x, n, q32), tol=1e-4),
          "10d: a full probe with f32 queries differs from their exact scan")
    del x, ivf
    torch.cuda.empty_cache()
    return recall_at_10(f_rows, rows)


def synth_blocks(results):
    """10e: ``synth_corpus.make_block_fn`` on the card: pure in (seed, i),
    unit-norm rows, about 64 rows a cluster."""
    import torch

    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn

    t0 = time.perf_counter()
    block_fn = make_block_fn(SEED, 1, block_rows=SYNTH_BLOCK_ROWS, device=DEV)
    a, b, c = block_fn(0), block_fn(0), block_fn(1)
    check(tuple(a.shape) == (SYNTH_BLOCK_ROWS, 384)
          and a.dtype == torch.bfloat16, "10e: not a [2^20, 384] bf16 block")
    check(torch.equal(a, b) and not torch.equal(a, c),
          "10e: a block is not a pure function of (seed, i)")
    norm_err = float((torch.linalg.vector_norm(a.float(), dim=1) - 1.0)
                     .abs().max())
    check(norm_err <= 1e-2, f"10e: rows off unit norm by {norm_err:.3g}")
    ids = block_fn.cluster_ids(0)
    mean = ids.numel() / torch.unique(ids).numel()
    check(abs(mean - 64) <= 2, f"10e: {mean:.2f} rows a cluster, not 64")
    sync()
    out = {"n_clusters": block_fn.n_clusters, "norm_max_abs_err": norm_err,
           "rows_per_cluster": mean, "seconds": time.perf_counter() - t0}
    del a, b, c, block_fn
    results["baseline"]["synth_corpus"] = out
    log("  10e: " + json.dumps(out))


def baseline_configs(results):
    """Phase 10, parts 10a-10e; each part runs with the counts set to 0 just
    before it.  → launches by part."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    results["baseline"] = {"allocated_gib_before": torch.cuda.memory_allocated()
                           / 2 ** 30 if DEV == "cuda" else None}
    parts = config3(results)
    parts.update(config5_vector(results))
    parts.update(config5_hybrid(results))
    parts.update(sweeps(results))
    synth_blocks(results)
    torch.cuda.empty_cache()
    return parts


# ----------------------------------------------------------------- phase 11
def machine_capacity() -> dict:
    """``free -g`` and ``df -h`` of the plane's directory, as they print."""
    out = {}
    for key, cmd in (("free_g", ["free", "-g"]),
                     ("df_h", ["df", "-h", CFG4_TMP])):
        try:
            out[key] = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as exc:
            out[key] = f"unavailable: {exc}"
    return out


def host_score_err(store, q, results) -> float:
    """Largest gap between the (vals, rows) ``results`` of queries ``q``
    and the exact products of ``q`` with the host plane's rows."""
    import numpy as np

    err = 0.0
    for vals, rows in results:
        rows_f32 = store.get(rows.reshape(-1)).reshape(*rows.shape, -1)
        err = max(err, float(np.abs(
            vals - np.einsum("bkd,bd->bk", rows_f32, q)).max()))
    return err


def config4_fill(results) -> str:
    """11a: ``torch_fill_host_store.fill`` of CFG4_BLOCKS blocks into a bf16
    plane under CFG4_TMP; its sample rows and 16 more bit for bit."""
    import numpy as np

    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn
    from scripts import torch_fill_host_store as fill

    os.makedirs(CFG4_TMP, exist_ok=True)
    capacity = machine_capacity()
    log("  11a machine: " + json.dumps(capacity))
    path = os.path.join(CFG4_TMP, "config4.bf16")
    out = fill.fill(path, blocks=CFG4_BLOCKS, block_rows=CFG4_BLOCK_ROWS,
                    device=DEV, log=lambda _m: None)
    n = CFG4_BLOCKS * CFG4_BLOCK_ROWS
    check(out["rows"] == n and out["blocks_filled"] == CFG4_BLOCKS,
          f"11a: the plane holds {out['rows']} rows, not {n}")
    rows = np.random.default_rng(SEED + 61).choice(n, 16, replace=False)
    fill.verify_rows(fill.open_store(path, n, 384),
                     make_block_fn(0, CFG4_BLOCKS, block_rows=CFG4_BLOCK_ROWS,
                                   device=DEV), rows, CFG4_BLOCK_ROWS)
    out = dict(out, extra_verified_rows=sorted(int(r) for r in rows),
               machine=capacity)
    results["config4"]["fill"] = out
    log(f"  11a: {n} rows ({n * 384 * 2 / 1e9:.1f} GB) in "
        f"{out['seconds']:.1f} s, {out['gb_per_s']:.2f} GB/s; sample rows "
        f"bit-identical")
    return path


def config4_single(results, path):
    """11b: ``torch_run_config4.measure`` over the plane at the JAX r05
    build (nlist 16384, block 512, spill 0.15, OPQ 4), then its gates."""
    import torch

    from archi_tpu_torch.engine.topk import topk_lower_first
    from scripts import torch_run_config4 as cfg4

    shapes = KernelShapes()
    n = CFG4_BLOCKS * CFG4_BLOCK_ROWS
    (payload, state), parts, secs, peak = counted(
        "config4", ("fused_topk", "adc_scores_lut16"),
        lambda: cfg4.measure(None, rows=n, block_rows=CFG4_BLOCK_ROWS,
                             store_path=path, nlist=CFG4_NLIST, block=512,
                             spill=0.15, opq=4, rerank_sweep=CFG4_RERANK,
                             device=DEV, log=lambda m: log("    " + m)),
        shapes=shapes)
    store, q, block_fn = state["store"], state["q"], state["block_fn"]
    check(store is not None and payload["host_store"]["rows"] == n,
          "11b: the run did not take the host plane")
    # the GT scan against a chunked plain f32 exact scan of the same blocks
    qd = torch.as_tensor(q, device=DEV)
    vals, rows = [], []
    for i in range(CFG4_BLOCKS):
        v, p = topk_lower_first(qd @ block_fn(i).float().T, 10)
        vals.append(v)
        rows.append(p + i * CFG4_BLOCK_ROWS)
    v, p = topk_lower_first(torch.cat(vals, 1), 10)
    want_r = torch.gather(torch.cat(rows, 1), 1, p).cpu().numpy()
    check(same_rows(state["exact_vals"], state["exact"], v.cpu().numpy(),
                    want_r, tol=1e-4),
          "11b: the GT scan differs from the plain f32 exact scan")
    err = host_score_err(store, q, state["rerank_out"])
    check(err <= 1e-4, f"11b: rerank scores off the host rows by {err:.3g}")
    sweep, rerank = payload["nprobe_sweep"], payload["rerank_sweep"]
    largest = max(rerank, key=lambda e: (e["nprobe_blocks"], e["rerank_c"]))
    check(largest["self_top1"] == 1.0,
          f"11b: self_top1 {largest['self_top1']} at the largest budget")
    check(payload["headline"].get("recall_score_at_10", 0) >= 0.99,
          f"11b: headline {payload['headline']} below 0.99")
    recall = [e["recall_strict_at_10"] for e in sweep]
    check(all(a <= b for a, b in zip(recall, recall[1:])),
          f"11b: ADC-only recall falls with nprobe {recall}")
    idx = state["index"]
    out = dict(payload, seconds=secs, peak_gib=peak,
               rerank_score_max_abs_err=err, shapes=shapes.as_dict(),
               n_code_blocks=int(idx.code_blocks.shape[0]),
               max_bpc=int(idx.cell_blocks.shape[1]))
    del state, store
    torch.cuda.empty_cache()
    results["config4"]["single"] = out
    log("  11b: " + json.dumps({k: out[k] for k in (
        "build_s", "codes_gb", "exact_gt_scan_s", "relay_rtt_ms", "headline",
        "seconds", "peak_gib", "rerank_score_max_abs_err", "n_code_blocks",
        "max_bpc")}))
    log("  11b shapes: " + json.dumps(out["shapes"]))
    return parts, idx


def config4_sharded(results, path):
    """11c: ``torch_run_config4_sharded.measure`` with CFG4_SHARDS logical
    shards over the plane: recall@10 at least 0.9 at the largest budget,
    scores equal to the host rows; the comparison with 11b at equal total
    budgets logged."""
    import torch

    from scripts import torch_run_config4_sharded as cfg4s

    shapes = KernelShapes()
    (payload, state), parts, secs, peak = counted(
        "config4_sharded", ("fused_topk", "adc_scores_lut16"),
        lambda: cfg4s.measure(None, shards=CFG4_SHARDS, store_path=path,
                              budgets=CFG4_BUDGETS, nlist=CFG4_NLIST,
                              block_rows=CFG4_BLOCK_ROWS, device=DEV,
                              log=lambda m: log("    " + m)),
        shapes=shapes)
    err = host_score_err(state["parent"], state["q"], state["searches"])
    check(err <= 1e-4, f"11c: scores off the host rows by {err:.3g}")
    last = payload["sweep"][-1]
    check(last["recall_strict_at_10"] >= 0.9,
          f"11c: recall@10 {last['recall_strict_at_10']} < 0.9")
    single = {e["nprobe_blocks"]: e for e in
              results["config4"]["single"]["rerank_sweep"]
              if e["rerank_c"] == last["total_rerank_c"]}
    parity = [{"budget": e["total_probe_blocks"],
               "sharded": {k: e[k] for k in ("recall_strict_at_10",
                                             "recall_score_at_10",
                                             "query_qps")},
               "single": {k: single[e["total_probe_blocks"]][k] for k in (
                   "recall_strict_at_10", "recall_score_at_10",
                   "query_qps")} if e["total_probe_blocks"] in single
               else None} for e in payload["sweep"]]
    del state
    torch.cuda.empty_cache()
    out = dict(payload, seconds=secs, peak_gib=peak, score_max_abs_err=err,
               parity_with_11b=parity, shapes=shapes.as_dict())
    results["config4"]["sharded"] = out
    log("  11c: " + json.dumps({k: out[k] for k in (
        "build_s", "seconds", "peak_gib", "score_max_abs_err")}))
    log("  11c against 11b at equal budgets: " + json.dumps(parity))
    log("  11c shapes: " + json.dumps(out["shapes"]))
    return parts


def shard_scaling(results):
    """11d: ``torch_bench_shard_scaling.measure`` at SCALING_ROWS, its flat
    tier (the script's ``--skip-xl``: the XL tier's four builds took 84 of
    11d's 126 s, and 11c and 9d measure the same sharded XL search and its
    profile split): each sharded flat index's search equals one index over
    its rows (1e-6, tie-aware), and its scan-only shards, merged, equal
    it."""
    import torch

    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.sharded_index import _merge
    from scripts import torch_bench_shard_scaling as scaling

    kept = []
    shapes = KernelShapes()
    payload, parts, secs, peak = counted(
        "shard_scaling", ("fused_topk",),
        lambda: scaling.measure(
            None, rows=SCALING_ROWS, skip_xl=True, device=DEV,
            keep=lambda _kind, s, idx: kept.append((s, idx)),
            log=lambda m: log("    " + m)),
        shapes=shapes)
    g = torch.Generator(device=DEV).manual_seed(SEED + 71)
    q = torch.nn.functional.normalize(
        torch.randn(32, 384, device=DEV, generator=g), dim=1)
    for s, idx in kept:
        one = FlatIndex(384, normalize=False, device=DEV)
        one.add(idx.emb[:idx.n_rows], list(range(idx.n_rows)))
        want_v, want_r = one.search_dispatch(q, k=10)
        got_v, got_r = idx.search_dispatch(q, k=10)
        check(same_rows(got_v.cpu().numpy(), got_r.cpu().numpy(),
                        want_v.cpu().numpy(), want_r.cpu().numpy(),
                        tol=1e-6),
              f"11d: {s} shards differ from one index")
        parts_ = scaling.scan_only(idx, q)
        mv, mr = _merge(torch.cat([v for v, _r in parts_], 1),
                        torch.cat([r for _v, r in parts_], 1), 10)
        check(torch.equal(mv, got_v) and torch.equal(mr, got_r),
              f"11d: {s} shards' scan-only results, merged, differ")
        del one
    check([s for s, _i in kept] == list(scaling.SHARD_COUNTS),
          f"11d: flat indexes at {[s for s, _i in kept]} shards")
    del kept
    torch.cuda.empty_cache()
    out = dict(payload, seconds=secs, peak_gib=peak, shapes=shapes.as_dict())
    results["config4"]["shard_scaling"] = out
    log(f"  11d: {secs:.1f} s, peak {peak} GiB; shapes "
        + json.dumps(out["shapes"]))
    return parts


def config4(results):
    """Phase 11, parts 11a-11d; each of 11b-11d runs with the counts set to
    0 just before it.  → (launches by part, 11b's index, kept for 12h)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    results["config4"] = {}
    path = config4_fill(results)
    parts, index = config4_single(results, path)
    parts.update(config4_sharded(results, path))
    parts.update(shard_scaling(results))
    return parts, index


# ----------------------------------------------------------------- phase 12
def scripts_serving(results):
    """12a: ``torch_bench_serving.measure`` in both modes over 2^20 x 384
    bf16 rows; SERVE_SAMPLE sampled answers of every run against a direct
    single-query top-k (tie-aware, 1e-4); the in-process batch function
    makes no host sync."""
    import numpy as np
    import torch

    from archi_tpu_torch.engine.topk import topk_scores
    from scripts import torch_bench_serving as serving

    out, parts = {}, {}
    for mode, in_process in (("dispatch", False), ("in_process", True)):
        shapes = KernelShapes()
        (payload, state), part, secs, peak = counted(
            f"scripts_serving_{mode}", ("fused_topk",),
            lambda: serving.measure(
                clients=SERVE_CLIENTS, per_client=SERVE_PER_CLIENT,
                batches=SERVE_BATCHES, in_process=in_process,
                rows=serving.N,
                sample=SERVE_SAMPLE, device=DEV,
                log=lambda m: log("    " + m)),
            shapes=shapes)
        parts.update(part)
        corpus, queries = state["corpus"], state["queries"]
        n = corpus.shape[0]
        check(n == serving.N and corpus.dtype == torch.bfloat16,
              f"12a: corpus {tuple(corpus.shape)} {corpus.dtype}")
        bias = torch.zeros((n,), dtype=torch.float32, device=DEV)
        for (_m, mbs), got in state["answers"].items():
            check(len(got) == SERVE_SAMPLE,
                  f"12a {mode} {mbs}: {len(got)} sampled answers")
            for gi, (vals, rows) in got.items():
                wv, wr = topk_scores(
                    torch.as_tensor(queries[gi][None], device=DEV), corpus,
                    bias, n, k=serving.K)
                check(same_rows(np.asarray(vals)[None],
                                np.asarray(rows)[None], wv.cpu().numpy(),
                                wr.cpu().numpy(), tol=1e-4),
                      f"12a {mode} {mbs}: request {gi} differs from a "
                      f"direct single-query top-k")
        if in_process:
            syncs = [e["host_syncs_per_batch"] for e in payload["sweep"]
                     if e.get("mode") == "in_process_async"]
            check(syncs and not any(syncs),
                  f"12a: the in-process batch function synchronised {syncs}")
        out[mode] = dict(payload, seconds=secs, peak_gib=peak,
                         shapes=shapes.as_dict())
        log(f"  12a {mode}: " + json.dumps(
            {k: payload[k] for k in payload if k != "device"}))
        log(f"  12a {mode} shapes: " + json.dumps(out[mode]["shapes"]))
        del state, corpus
        torch.cuda.empty_cache()
    results["scripts"]["serving"] = out
    return parts


def scripts_http(results):
    """12b: ``torch_bench_serving_http.measure`` on the card; every status
    200 (the script raises otherwise); HTTP_SAMPLE answers of each hybrid
    wave equal ``store.hybrid_search`` (tie-aware, 1e-4)."""
    import torch

    from scripts import torch_bench_serving_http as http_bench

    shapes = KernelShapes()
    (payload, state), parts, secs, peak = counted(
        "scripts_http", ("fused_topk",),
        lambda: http_bench.measure(
            os.path.join(SCRIPTS_TMP, "serving_http.json"),
            clients=HTTP_CLIENTS, per_client=HTTP_PER_CLIENT,
            n_chunks=HTTP_CHUNKS, sample=HTTP_SAMPLE,
            data_path=os.path.join(SCRIPTS_TMP, "http_data"), device=DEV,
            log=lambda m: log("    " + m)),
        shapes=shapes)
    store = state["store"]
    index = store.index
    check((index.capacity, index.n_rows) == (HTTP_CAPACITY, HTTP_CHUNKS),
          f"12b: index {index.n_rows} rows in {index.capacity}, not the "
          f"shape at which phase 2 holds fused_topk")
    for wave, got in state["answers"].items():
        check(len(got) == HTTP_SAMPLE, f"12b {wave}: {len(got)} answers")
        for qi, body in got.items():
            want = store.hybrid_search(state["queries"][qi], k=5)
            keys = {src: i for i, src in enumerate(
                {h["metadata"]["source"] for h in body}
                | {d.metadata["source"] for d, _s in want})}
            check(len(body) == len(want) and same_rows(
                [[h["score"] for h in body]],
                [[keys[h["metadata"]["source"]] for h in body]],
                [[sc for _d, sc in want]],
                [[keys[d.metadata["source"]] for d, _s in want]], tol=1e-4),
                f"12b {wave}: request {qi} differs from hybrid_search")
    out = dict(payload, seconds=secs, peak_gib=peak, shapes=shapes.as_dict())
    del state, store, index
    torch.cuda.empty_cache()
    results["scripts"]["http"] = out
    log("  12b: " + json.dumps({k: out[k] for k in (
        "noop_http", "hybrid_end_to_end", "hybrid_micro_batched",
        "seconds")}))
    log("  12b shapes: " + json.dumps(out["shapes"]))
    return parts


def scripts_ingest(results):
    """12c: ``torch_bench_ingest.measure`` at INGEST_N chunks: the count and
    the BM25 documents equal n; the final hybrid answer equals phase 3's
    brute force."""
    import torch

    from scripts import torch_bench_ingest as ingest

    shapes = KernelShapes()
    (payload, state), parts, secs, peak = counted(
        "scripts_ingest", ("fused_topk", "encoder_attention"),
        lambda: ingest.measure(INGEST_N, INGEST_BATCH, device=DEV,
                               log=lambda m: log("    " + m)),
        shapes=shapes)
    store = state["store"]
    check(payload["index_rows"] == INGEST_N == payload["bm25_docs"],
          f"12c: {payload['index_rows']} rows, {payload['bm25_docs']} BM25 "
          f"documents, not {INGEST_N}")
    check(store.index.capacity == INGEST_CAPACITY,
          f"12c: capacity {store.index.capacity}, not the shape at which "
          f"phase 2 holds fused_topk")
    want = brute_force_hybrid(store, ["term1 term2"], 5)[0]
    check(same_ranking(state["hits"], want),
          "12c: the final hybrid answer differs from brute force")
    out = dict(payload, seconds=secs, peak_gib=peak, shapes=shapes.as_dict())
    del state, store
    torch.cuda.empty_cache()
    results["scripts"]["ingest"] = out
    log("  12c: " + json.dumps(out))
    return parts


def scripts_encoder(results):
    """12d: ``torch_bench_encoder.measure`` at ENC_BATCH x ENC_SEQ for each
    of ENC_MODELS; the kernel route's pooled output equals the plain
    route's on the same ids within a bf16 step (2^-7)."""
    import torch

    from archi_tpu_torch.models.bert import encode
    from scripts import torch_bench_encoder as enc

    out, parts = {}, {}
    for model in ENC_MODELS:
        shapes = KernelShapes()
        (payload, state), part, secs, peak = counted(
            f"scripts_encoder_{model}", ("encoder_attention",),
            lambda: enc.measure(ENC_BATCH, ENC_SEQ, ENC_STEPS, model,
                                device=DEV, log=lambda m: log("    " + m)),
            shapes=shapes)
        parts.update(part)
        chain, m = state["chain"], state["model"]
        ids = chain.ids_from(torch.ones((ENC_BATCH, m.config.hidden_size),
                                        device=DEV))
        got = encode(m, ids, chain.mask, attention_impl="kernel")
        want = encode(m, ids, chain.mask, attention_impl="plain")
        err = float((got - want).abs().max())
        check(err <= 2.0 ** -7,
              f"12d {model}: kernel and plain routes differ by {err:.3g}")
        out[model] = dict(payload, seconds=secs, peak_gib=peak,
                          kernel_vs_plain_max_abs=err,
                          shapes=shapes.as_dict())
        del state, chain, m, got, want
        torch.cuda.empty_cache()
        log(f"  12d {model}: " + json.dumps(out[model]))
    results["scripts"]["encoder"] = out
    return parts


def scripts_quality(results):
    """12e: ``torch_run_quality.run --encoder both`` at QUALITY_STEPS
    training steps: the hash section's totals and ablations equal a CPU
    run's, the training loss falls.  12f: ``torch_exp_encoder.run``
    --hash-only (equal to 12e's ablations) and one trained tag at
    EXP_STEPS."""
    from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder
    from scripts import torch_exp_encoder as exp
    from scripts import torch_run_quality as quality

    out, losses = {}, []
    shapes = KernelShapes()
    payload, parts, secs, peak = counted(
        "scripts_quality", ("fused_topk", "encoder_attention"),
        lambda: quality.run(
            os.path.join(SCRIPTS_TMP, "quality.json"), encoder="both",
            model_dir=os.path.join(SCRIPTS_TMP, "quality_model"),
            steps=QUALITY_STEPS,
            out_dir=os.path.join(SCRIPTS_TMP, "quality_results"),
            device=DEV, log=lambda _m: None, losses=losses),
        shapes=shapes)
    cpu = quality.run_section(
        HashedNgramEmbedder(), "cpu", device="cpu",
        out_dir=os.path.join(SCRIPTS_TMP, "quality_results_cpu"))
    keys = ("source_accuracy", "relative_source_accuracy", "recall_at_10",
            "retriever_ablation", "hard_query_ablation",
            "synonym_query_ablation", "n_questions", "chunks")
    diff = {k: (payload["hash"][k], cpu[k]) for k in keys
            if payload["hash"][k] != cpu[k]}
    check(not diff, f"12e: the hash section on the card differs from the "
          f"CPU run: {diff}")
    check(len(losses) == QUALITY_STEPS and
          sum(losses[-10:]) < sum(losses[:10]),
          f"12e: the loss did not fall ({losses[:3]} ... {losses[-3:]})")
    out["quality"] = dict(payload, seconds=secs, peak_gib=peak,
                          loss_first=losses[0], loss_last=losses[-1],
                          shapes=shapes.as_dict())
    log("  12e: " + json.dumps({k: out["quality"][k] for k in (
        "source_accuracy", "recall_at_10", "seconds", "loss_first",
        "loss_last")}))
    log("  12e hash: " + json.dumps(payload["hash"]))
    log("  12e trained: " + json.dumps(payload["trained"]))
    log("  12e shapes: " + json.dumps(out["quality"]["shapes"]))

    shapes = KernelShapes()
    exp_log = os.path.join(SCRIPTS_TMP, "enc_experiments.jsonl")
    (hash_res, trained), part, secs, peak = counted(
        "scripts_exp_encoder", ("fused_topk", "encoder_attention"),
        lambda: (exp.run(hash_only=True, log_path=exp_log, device=DEV,
                         log=lambda _m: None),
                 exp.run("chip", train_kw={
                     "batch": 128, "seq_len": 96, "seed": 0,
                     "steps": EXP_STEPS}, log_path=exp_log,
                     model_dir=os.path.join(SCRIPTS_TMP, "exp_model"),
                     device=DEV, log=lambda _m: None)),
        shapes=shapes)
    parts.update(part)
    h = payload["hash"]
    for family, section in (("main", "retriever_ablation"),
                            ("hard", "hard_query_ablation"),
                            ("synonym", "synonym_query_ablation")):
        for mode in ("hybrid", "semantic_only"):
            check(hash_res[family][mode] == h[section][f"{mode}_hit@5"],
                  f"12f: --hash-only {family} {mode} "
                  f"{hash_res[family][mode]} differs from 12e's "
                  f"{h[section][f'{mode}_hit@5']}")
    out["exp_encoder"] = {"hash": hash_res, "trained": trained,
                          "seconds": secs, "peak_gib": peak,
                          "shapes": shapes.as_dict()}
    log("  12f: " + json.dumps(out["exp_encoder"]))
    results["scripts"].update(out)
    return parts


def start(cmd, log_path):
    """A background process of this run, its output to ``log_path``."""
    with open(log_path, "w") as out:
        return subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHON=sys.executable))


def finish(proc, log_path, part, timeout) -> str:
    """Wait for a background process; its output, or the run fails."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(log_path) as f:
        text = f.read()
    check(proc.returncode == 0,
          f"{part}: exit {proc.returncode}: {text[-2000:]}")
    return text


class AnnAdoption:
    """12g: an ``AnnFlatIndex(snapshot_kind="ivfpq")`` over ``rows``
    clustered rows (phase 5's generator), its corpus exported for
    ``scripts/torch_ann_builder.py --device <device>`` in a subprocess, the
    snapshot adopted and searched: recall@10 against the exact scan at
    least 0.6 (path A's bar), every ADC launch at a shape phase 2 holds;
    after a compaction, adopt refuses."""

    def __init__(self, rows: int, device: str, seed: int):
        import torch

        from archi_tpu_torch.engine.ann_index import AnnFlatIndex

        self.rows, self.device = rows, device
        self.idx = AnnFlatIndex(384, nlist=ANN_NLIST, snapshot_kind="ivfpq",
                                min_snapshot_rows=1 << 40,
                                async_refresh=False, dtype=torch.bfloat16,
                                device=DEV)
        gen = ClusteredRows(rows, seed)
        step = min(rows, 1 << 16)
        for s in range(0, rows, step):
            self.idx.add(gen.rows(step), ids=list(range(s, s + step)))
        self.q = gen.rows(32)
        self.want = exact_scan(self.idx.emb, rows,
                               self.q.bfloat16().float())[1]
        self.prefix = os.path.join(SCRIPTS_TMP, f"ann_{device}.npz")
        self.idx.export_corpus(self.prefix)

    def command(self):
        return [sys.executable, os.path.join(ROOT, "scripts",
                                             "torch_ann_builder.py"),
                "--corpus", self.prefix, "--kind", "ivfpq", "--nlist",
                str(ANN_NLIST), "--device", self.device]

    def adopt(self, results, build_log):
        import numpy as np

        shapes = KernelShapes()

        def run():
            ok = self.idx.adopt_snapshot(self.prefix)
            _ids, _vals, rows = self.idx.search(self.q, k=10)
            return ok, rows

        (ok, rows), parts, secs, peak = counted(
            f"scripts_ann_{self.device}", ("adc_scores",), run,
            shapes=shapes)
        check(ok and self.idx._n_snap == self.rows,
              f"12g: the {self.device} snapshot was not adopted")
        rec = recall_at_10(np.asarray(rows.cpu() if hasattr(rows, "cpu")
                                      else rows), self.want)
        check(rec >= 0.6, f"12g {self.device}: recall@10 {rec:.3f} < 0.6")
        unheld = [key for key in shapes.adc
                  if (key[0], key[1], key[2], key[3]) not in
                  {("adc_scores", 48, g, s_) for g, s_ in ANN_ADC_SHAPES}]
        check(not unheld, f"12g {self.device}: ADC shapes {unheld} are not "
              f"held in phase 2")
        built = re.search(r"snapshot built in ([0-9.]+)s", build_log)
        out = {"rows": self.rows, "recall_at_10": rec,
               "build_s": float(built.group(1)) if built else None,
               "adopt_search_s": secs, "peak_gib": peak,
               "shapes": shapes.as_dict()}
        results["scripts"].setdefault("ann_builder", {})[self.device] = out
        log(f"  12g {self.device}: " + json.dumps(out))
        return parts

    def refuse_after_compaction(self, results):
        self.idx.delete([0, 1])
        self.idx.compact()
        check(not self.idx.adopt_snapshot(self.prefix),
              "12g: adopt took a snapshot exported before a compaction")
        results["scripts"]["ann_builder"]["refused_after_compaction"] = True


def scripts_diag(results, index):
    """12h: ``torch_diag_cfg4_misses.measure`` over 11b's plane and index
    (held from 11b: its save and reload would cost about a minute), probe
    DIAG_PROBE, C DIAG_RERANK: the misses split into the two kinds;
    strict@10 within 1/320 of 11b's strict recall at the same budget (11b's
    ground truth is f32, this one bf16, as in the JAX script)."""
    import torch

    from scripts import torch_diag_cfg4_misses as diag

    n = CFG4_BLOCKS * CFG4_BLOCK_ROWS
    shapes = KernelShapes()
    (payload, _state), parts, secs, peak = counted(
        "scripts_diag", ("fused_topk", "adc_scores_lut16"),
        lambda: diag.measure(
            os.path.join(SCRIPTS_TMP, "miss_diag.json"), rows=n,
            index=index, store_path=os.path.join(CFG4_TMP, "config4.bf16"),
            probe=DIAG_PROBE, rerank_c=DIAG_RERANK,
            block_rows=CFG4_BLOCK_ROWS, device=DEV,
            log=lambda m: log("    " + m)),
        shapes=shapes)
    check(payload["n_missed"] == payload["n_missed_in_candidate_set"]
          + payload["n_missed_geometry"], "12h: the misses do not add up")
    single = [e for e in results["config4"]["single"]["rerank_sweep"]
              if (e["nprobe_blocks"], e["rerank_c"]) == (DIAG_PROBE,
                                                         DIAG_RERANK)]
    check(len(single) == 1, f"12h: 11b ran no ({DIAG_PROBE}, {DIAG_RERANK})")
    gap = payload["strict_at_10"] - single[0]["recall_strict_at_10"]
    check(abs(gap) <= 1 / 320 + 1e-9,
          f"12h: strict@10 {payload['strict_at_10']} against 11b's "
          f"{single[0]['recall_strict_at_10']}")
    out = dict(payload, seconds=secs, peak_gib=peak, gap_to_11b=gap,
               shapes=shapes.as_dict())
    torch.cuda.empty_cache()
    results["scripts"]["diag"] = out
    log("  12h: " + json.dumps({k: out[k] for k in (
        "strict_at_10", "n_missed", "n_missed_in_candidate_set",
        "n_missed_geometry", "gt_boundary_gap_median", "gap_to_11b",
        "seconds")}))
    log("  12h shapes: " + json.dumps(out["shapes"]))
    return parts


def scripts_refold(results):
    """12i: ``torch_bench_attention_refold.measure`` at B REFOLD_B, S
    REFOLD_S: the folded and the int8 layers against the baseline within
    the script's bf16 and int8 bars (relative, all elements)."""
    import torch

    from scripts import torch_bench_attention_refold as refold

    (payload, state), parts, secs, peak = counted(
        "scripts_refold", (),
        lambda: refold.measure(REFOLD_B, REFOLD_S, steps=REFOLD_STEPS,
                               trials=REFOLD_TRIALS, device=DEV,
                               log=lambda _m: None))
    outs = state["outputs"]
    errs = {name: refold.rel_err(outs[name], outs["baseline_xla"])
            for name in ("folded_bigK", "int8_dots")}
    check(errs["folded_bigK"] <= refold.BF16_TOL,
          f"12i: the folded layer is {errs['folded_bigK']:.3g} off")
    check(errs["int8_dots"] <= refold.INT8_TOL,
          f"12i: the int8 layer is {errs['int8_dots']:.3g} off")
    del state, outs
    torch.cuda.empty_cache()
    out = dict(payload, seconds=secs, peak_gib=peak, rel_err=errs)
    results["scripts"]["refold"] = out
    log("  12i: " + json.dumps(out))
    return parts


def scripts_phase(results, cfg4_index):
    """Phase 12, parts 12a-12j; each of 12a-12i runs with the counts set to
    0 just before it.  The timed parts (12a-12d, 12i) run alone; then 12g's
    two snapshot builds and 12j (the smoke script's services), other
    processes, run in the background beside the checks of 12e-12h.
    → launches by part."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(SCRIPTS_TMP, exist_ok=True)
    results["scripts"] = {"curl": shutil.which("curl")}
    seconds = {}
    t0 = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds[part], t0[0] = now - t0[0], now

    parts = scripts_serving(results)
    lap("12a")
    parts.update(scripts_http(results))
    lap("12b")
    parts.update(scripts_ingest(results))
    lap("12c")
    parts.update(scripts_encoder(results))
    lap("12d")
    parts.update(scripts_refold(results))
    lap("12i")
    logs = {k: os.path.join(SCRIPTS_TMP, f"{k}.log")
            for k in ("ann_cpu", "ann_cuda", "smoke")}
    ann = AnnAdoption(ANN_ROWS, "cuda", SEED + 81)
    ann_cpu = AnnAdoption(ANN_CPU_ROWS, "cpu", SEED + 82)
    lap("12g_export")
    background = [start(ann.command(), logs["ann_cuda"]),
                  start(ann_cpu.command(), logs["ann_cpu"]),
                  start(["bash", os.path.join(ROOT, "scripts",
                                              "torch_smoke.sh")],
                        logs["smoke"])]
    cuda_build, cpu_build, smoke = background
    try:
        parts.update(scripts_quality(results))
        lap("12ef")
        parts.update(scripts_diag(results, cfg4_index))
        lap("12h")
        text = finish(cuda_build, logs["ann_cuda"], "12g cuda build", 600)
        parts.update(ann.adopt(results, text))
        lap("12g_cuda")
        text = finish(cpu_build, logs["ann_cpu"], "12g cpu build", 600)
        parts.update(ann_cpu.adopt(results, text))
        ann.refuse_after_compaction(results)
        lap("12g_cpu")
        text = finish(smoke, logs["smoke"], "12j", 600)
        check("SMOKE PASSED" in text, f"12j: {text[-2000:]}")
        results["scripts"]["smoke"] = text.strip().splitlines()[-3:]
        lap("12j")
        log("  12j: " + " | ".join(results["scripts"]["smoke"]))
    finally:
        # SIGTERM first: the smoke script's trap deletes its deployment
        for proc in background:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    del ann, ann_cpu
    torch.cuda.empty_cache()
    results["scripts"]["part_seconds"] = seconds
    log("  phase 12 parts (s): " + json.dumps(seconds))
    return parts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from archi_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase_log(text):
        log(f"{text} [{time.perf_counter() - t_start:.0f} s]")

    card = card_line()
    log(card)
    phase_log("phase 1: build")
    from archi_tpu_torch import native

    t0 = time.perf_counter()
    analyzer = threading.Thread(target=native.load_library)
    analyzer.start()
    secs = _build.build()
    analyzer.join()
    check(native.load_library() is not None,
          "the native text analyzer did not build or load")
    log(f"  native text analyzer {native.lib_path()} ready "
        f"{time.perf_counter() - t0:.1f} s after the build started")
    ptxas = {name: kernel_resources(out)
             for name, out in sorted(_build.BUILD_LOGS.items())}
    for name, kernels in ptxas.items():
        log(f"  {name}:")
        for kernel, use in kernels.items():
            log(f"    {kernel}: {use}")
    log(f"  built {_build.sources()} in {secs:.1f} s")

    phase_log("phase 2: kernels against their plain versions")
    results: dict = {"card": card, "build_s": secs, "ptxas": ptxas}
    bf16 = torch.bfloat16
    topk = [
        # the main path's shapes: 2^20 live rows in a 2^21-row index
        topk_case("topk_b32_shared_bf16", 32, N_CAPACITY, N_ROWS, bf16,
                  False, timed=True),
        topk_case("topk_b256_shared_bf16", 256, N_CAPACITY, N_ROWS, bf16,
                  False, timed=True),
        topk_case("topk_b32_perquery_bf16", 32, N_CAPACITY, N_ROWS, bf16,
                  True, timed=True),
        topk_case("topk_b1_k5_bf16", 1, N_CAPACITY, N_ROWS, bf16, False, k=5),
        topk_case("topk_b1_k128_bf16", 1, N_CAPACITY, N_ROWS, bf16, True,
                  k=128),
        # a full 2^20-row index, the other storage types, a ragged edge
        topk_case("topk_b256_perquery_bf16", 256, N_ROWS, N_ROWS, bf16, True,
                  timed=True),
        topk_case("topk_b32_ragged_f32", 32, N_ROWS - 1003, N_ROWS - 5000,
                  torch.float32, False, timed=True),
        topk_case("topk_b32_int8", 32, N_ROWS, N_ROWS, torch.int8, False,
                  timed=True),
        topk_case("topk_b256_int8", 256, N_ROWS, N_ROWS, torch.int8, False,
                  timed=True),
        # wider rows, a ragged edge and k = 128 on the tensor-core route
        topk_case("topk_b33_k128_d768_bf16", 33, 300_007, 299_000, bf16, True,
                  k=128, d=768),
        # phase 9a's shards: 2^22 rows in 4 shards of 2^20; after growth
        # shards of 2^21, one with the 2^16 new rows, one empty
        topk_case("topk_b32_shard_bf16", 32, 1 << 20, 1 << 20, bf16, False,
                  timed=True),
        topk_case("topk_b256_shard_bf16", 256, 1 << 20, 1 << 20, bf16,
                  False),
        topk_case("topk_b32_perquery_shard_bf16", 32, 1 << 20, 1 << 20, bf16,
                  True),
        topk_case("topk_b32_grown_shard_bf16", 32, 1 << 21, 1 << 16, bf16,
                  False),
        topk_case("topk_b32_empty_shard_bf16", 32, 1 << 21, 0, bf16, False),
        # 7d's flat bf16 index (its shape checked there); hybrid batches of up to 32 with a per-query
        # BM25 bias, a direct hybrid query, a semantic batch
        topk_case("topk_b32_perquery_dm_bf16", 32, SVC_CAPACITY, SVC_ROWS,
                  bf16, True, timed=True),
        topk_case("topk_b1_perquery_dm_bf16", 1, SVC_CAPACITY, SVC_ROWS,
                  bf16, True),
        topk_case("topk_b8_shared_dm_bf16", 8, SVC_CAPACITY, SVC_ROWS, bf16,
                  False),
        # 7e's chats over the same index: one condensed query at a time,
        # k=5 (the chat's hybrid search) and k=20 (the rerank's pool)
        topk_case("topk_b1_k5_perquery_dm_bf16", 1, SVC_CAPACITY, SVC_ROWS,
                  bf16, True, k=5, timed=True),
        topk_case("topk_b1_k20_perquery_dm_bf16", 1, SVC_CAPACITY, SVC_ROWS,
                  bf16, True, k=20, timed=True),
        # 7f: the grader's semantic search (k=3) alone, 4 and 16 at once
        # over 7d's index; the benchmark's and evaluate's RETRIEVAL batch (the
        # fixture's 80 questions) and a direct hybrid question (k=5, its
        # BM25 bias one row) over the fixture's store, and evaluate
        # --beir's hybrid query (k=100)
        topk_case("topk_b1_k3_shared_dm_bf16", 1, SVC_CAPACITY, SVC_ROWS,
                  bf16, False, k=3, timed=True),
        topk_case("topk_b4_k3_shared_dm_bf16", 4, SVC_CAPACITY, SVC_ROWS,
                  bf16, False, k=3, timed=True),
        topk_case("topk_b16_k3_shared_dm_bf16", 16, SVC_CAPACITY, SVC_ROWS,
                  bf16, False, k=3, timed=True),
        topk_case("topk_b80_shared_eval_bf16", 80, EVAL_CAPACITY, EVAL_ROWS,
                  bf16, False, timed=True),
        topk_case("topk_b1_k5_eval_bf16", 1, EVAL_CAPACITY, EVAL_ROWS,
                  bf16, False, k=5, timed=True),
        topk_case("topk_b1_k100_beir_bf16", 1, EVAL_CAPACITY,
                  BEIR_TOPICS * BEIR_DOCS_PER_TOPIC, bf16, False, k=100,
                  timed=True),
        # 10a: BASELINE config 3's one-card slice, 8,802,304 live rows of
        # 768 in bf16 (13.5 GB; 6.76e9 elements, past 2^31), shared bias
        topk_case("topk_b32_config3_d768_bf16", 32, CFG3_ROWS, CFG3_ROWS,
                  bf16, False, d=768, timed=True),
        # 10b: config 5's 2^23-row index after the stream (2^23 - 2^17
        # prepopulated rows and 10 batches of 1024, one every 2 s for 20 s:
        # 10 or 11), its B=32 queries and the read-back of one row a batch;
        # 10d: the sweep's ground truth, 64 queries over 2^22 rows
        topk_case("topk_b32_config5_bf16", 32, CFG5_CAP, CFG5_LIVE, bf16,
                  False, timed=True),
        topk_case("topk_b10_config5_readback_bf16", 10, CFG5_CAP, CFG5_LIVE,
                  bf16, False, timed=True),
        topk_case("topk_b11_config5_readback_bf16", 11, CFG5_CAP, CFG5_LIVE,
                  bf16, False),
        topk_case("topk_b64_sweep_bf16", 64, PATH_ROWS, PATH_ROWS, bf16,
                  False, timed=True),
        # 11b / 11c: config 4's exact ground truth, B=32 over one generator
        # block of 2^20 x 384 upcast to f32 (the CUDA-core kernel); 11d: a
        # shard of the scaling's 2^20 rows at 8, 4 and 2 shards (1: the
        # 2^20-row shard above)
        topk_case("topk_b32_config4_gt_f32", 32, 1 << 20, 1 << 20,
                  torch.float32, False, timed=True),
        topk_case("topk_b32_scaling_shard8_bf16", 32, 1 << 17, 1 << 17,
                  bf16, False),
        topk_case("topk_b32_scaling_shard4_bf16", 32, 1 << 18, 1 << 18,
                  bf16, False),
        topk_case("topk_b32_scaling_shard2_bf16", 32, 1 << 19, 1 << 19,
                  bf16, False),
        # 12a: torch_bench_serving's buckets, B = 1 ... 256 over 2^20 x 384
        # bf16, shared zero bias (32 and 256: the 9a shard above); 12h: the
        # diagnostic's ground truth, B=32 at k=11 over one 2^20-row block
        *[topk_case(f"topk_b{b}_serving_bf16", b, 1 << 20, 1 << 20, bf16,
                    False, timed=True) for b in (1, 2, 4, 8, 16, 64, 128)],
        topk_case("topk_b32_k11_diag_bf16", 32, 1 << 20, 1 << 20, bf16,
                  False, k=11, timed=True),
        # 12b: the hash store's 4,096 rows in 8,192, k=5: a direct hybrid
        # query (shared bias) and the micro-batched ones (per-query bias,
        # buckets of 1 ... 64); 12c: the ingest's 16,384 rows, one query
        topk_case("topk_b1_k5_http_bf16", 1, HTTP_CAPACITY, HTTP_CHUNKS, bf16,
                  False, k=5, timed=True),
        *[topk_case(f"topk_b{b}_k5_perquery_http_bf16", b, HTTP_CAPACITY,
                    HTTP_CHUNKS, bf16, True, k=5, timed=b in (1, 64))
          for b in (1, 2, 4, 8, 16, 32, 64)],
        topk_case("topk_b1_k5_ingest_bf16", 1, INGEST_CAPACITY, INGEST_N,
                  bf16, False, k=5),
        # 12g: the CPU-built snapshot's store, 2^15 rows in 2^16: its empty
        # fresh tail's scan
        topk_case("topk_b32_ann_tail_bf16", 32, ANN_CPU_ROWS, 0, bf16,
                  False),
    ]
    attn = [
        # ingest (256 chunks in the 128 bucket) and queries (the 64 bucket,
        # batch buckets 8 and 32)
        attention_case("attn_b256_s128_bf16", 256, 128, torch.bfloat16,
                       timed=True),
        attention_case("attn_b8_s64_bf16", 8, 64, torch.bfloat16, timed=True),
        attention_case("attn_b32_s64_bf16", 32, 64, torch.bfloat16,
                       timed=True),
        attention_case("attn_b256_s512_bf16", 256, 512, torch.bfloat16,
                       timed=True),
        attention_case("attn_b64_s200_hd64_bf16", 64, 200, torch.bfloat16,
                       nh=6, hd=64),
        attention_case("attn_b256_s128_f32", 256, 128, torch.float32,
                       timed=True),
        attention_case("attn_b256_s512_f32", 256, 512, torch.float32),
        # phase 9e: a 256-document batch encoded in two halves
        attention_case("attn_b128_s128_bf16", 128, 128, torch.bfloat16,
                       timed=True),
        # 7d's ingest: a merged batch of 25 files' 1,000-character chunks
        # (about 125) in the 256 bucket, and a group past 128 chunks
        attention_case("attn_b128_s256_bf16", 128, 256, torch.bfloat16,
                       timed=True),
        attention_case("attn_b256_s256_bf16", 256, 256, torch.bfloat16),
        # 7e's chats: one query padded to the batch bucket of 8 in the 256
        # bucket (a conversation's condensed queries are long; its short
        # ones take attn_b8_s64), the rerank's query (1 x 32 tokens) and
        # its pool (20 x 128)
        attention_case("attn_b8_s256_bf16", 8, 256, torch.bfloat16,
                       timed=True),
        attention_case("attn_b1_s32_bf16", 1, 32, torch.bfloat16),
        attention_case("attn_b20_s128_bf16", 20, 128, torch.bfloat16),
        # 7f: a bot's question or a grade alone (8 x 128), the fixture's
        # ingest by the benchmark service (32 x 256, 128 x 64)
        attention_case("attn_b8_s128_bf16", 8, 128, torch.bfloat16,
                       timed=True),
        attention_case("attn_b32_s256_bf16", 32, 256, torch.bfloat16,
                       timed=True),
        attention_case("attn_b128_s64_bf16", 128, 64, torch.bfloat16,
                       timed=True),
        # 12d: bge-base at b256 s256 (MiniLM's: attn_b256_s256 above);
        # 12e / 12f: the trained small config (hidden 256, 4 heads of 64):
        # training batches (128 x 96, under autograd), the fixture's ingest
        # and the queries
        attention_case("attn_b256_s256_hd64_bf16", 256, 256, torch.bfloat16,
                       nh=12, hd=64, timed=True),
        *[attention_case(f"attn_b{b}_s{s_}_nh4_hd64_bf16", b, s_,
                         torch.bfloat16, nh=4, hd=64,
                         timed=(b, s_) in ((128, 96), (256, 128)))
          for b, s_ in ((8, 64), (32, 128), (128, 64), (128, 96), (256, 64),
                        (256, 128))],
    ]
    adc8 = [
        # path A: cell probing, one query a group (G=1) over 64 cells of up
        # to 11 blocks of 512 (the snapshot's max_bpc at seed 0); a group
        # of 4; adc_topk's G = batch
        adc_case("adc8_g1_m48_s360448", 48, 1, 64 * 11 * 512, False,
                 timed=True),
        adc_case("adc8_g4_m48_s131072", 48, 4, 1 << 17, False),
        adc_case("adc8_g256_m48_s65536", 48, 256, 1 << 16, False),
        adc_case("adc8_g32_m96_s100003_k100", 96, 32, 100_003, False,
                 ksub=100),
        # 12g: the adopted snapshots' cell probes
        *[adc_case(f"adc8_g{g}_m48_s{s_}_ann", 48, g, s_, False,
                   timed=(g, s_) == (2, 131072))
          for g, s_ in ANN_ADC_SHAPES],
    ]
    adc4 = [
        # path B: block probing, groups of 2 over 2 x 128 blocks of 512
        adc_case("adc4_g2_m48_s131072", 48, 2, 1 << 17, True, timed=True),
        adc_case("adc4_g1_m48_s999999", 48, 1, 999_999, True),
        adc_case("adc4_g256_m96_s4097", 96, 256, 4097, True),
        # 11b / 11c: config 4's block probing, m=96 (48 packed bytes a
        # row), one query a group over npb blocks of 512: npb 4096 (the
        # largest budget), 2048, 1024 (11c's largest a shard), 512, 256
        # (11c's smallest); 11b's ADC-only cell probing at 8 blocks (at
        # most 3 blocks a cell): groups of 4 at nprobe 16, of 2 at 32
        adc_case("adc4_g1_m96_s2097152", 96, 1, 4096 * 512, True,
                 timed=True),
        adc_case("adc4_g1_m96_s1048576", 96, 1, 2048 * 512, True),
        adc_case("adc4_g1_m96_s524288", 96, 1, 1024 * 512, True),
        adc_case("adc4_g1_m96_s262144", 96, 1, 512 * 512, True),
        adc_case("adc4_g1_m96_s131072", 96, 1, 256 * 512, True),
        adc_case("adc4_g4_m96_s98304", 96, 4, 16 * 3 * 512 * 4, True),
        adc_case("adc4_g2_m96_s98304", 96, 2, 32 * 3 * 512 * 2, True),
    ]
    results["topk"], results["attention"] = topk, attn
    results["adc_scores"], results["adc_scores_lut16"] = adc8, adc4
    torch.cuda.empty_cache()

    phase_log("phase 3: main path (MiniLM-L6 TorchEmbedder -> "
              "TorchVectorStore)")
    launches, store, emb, hybrid_q, docs, vocab = main_path(results)

    phase_log("phase 4: timings")
    timings(results, store, emb, hybrid_q, docs)
    phase_log("phase 7 inputs: phase 3's encoder and store written to "
              "disk")
    write_service_checkpoint(results, store, emb)
    del store
    torch.cuda.empty_cache()

    phase_log("phase 5: path A, type: ivfpq (AnnFlatIndex over "
              "TorchVectorStore)")
    launches_a, store_a, corpus, _q, _exact = path_a(results, emb, docs, vocab)

    phase_log("phase 6: path B, the XL tier's packed 4-bit snapshot")
    launches_b = path_b(results, store_a.index, corpus)
    del store_a, corpus, _q, _exact
    torch.cuda.empty_cache()

    phase_log("phase 7: the service layer (bootstrap, micro-batching, "
              "hot tail, XL, rerank)")
    try:
        parts = service_flat(results, docs, vocab)
        parts.update(service_hot_tail(results, docs, vocab))
        parts.update(service_xl(results, vocab))
        parts.update(service_data_manager(results, vocab))
    finally:
        shutil.rmtree(SERVICE_TMP, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_log("phase 8: the trainer at MiniLM-L6 width, its export served")
    try:
        parts.update(training(results, docs))
    finally:
        shutil.rmtree(TRAIN_TMP, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_log(f"phase 9: the multi-device tier, {SHARDS} shards on the card")
    t0 = time.perf_counter()
    try:
        parts.update(multi_device(results, emb, docs, vocab))
    finally:
        shutil.rmtree(SHARD_TMP, ignore_errors=True)
    results["shards"]["seconds"] = time.perf_counter() - t0
    log(f"  phase 9 took {results['shards']['seconds']:.1f} s ({card})")

    phase_log("phase 10: BASELINE configs 3 and 5, the sweeps, "
              "synth_corpus")
    t0 = time.perf_counter()
    parts.update(baseline_configs(results))
    results["baseline"]["seconds"] = time.perf_counter() - t0
    log(f"  phase 10 took {results['baseline']['seconds']:.1f} s ({card})")

    phase_log(f"phase 11: BASELINE config 4 on one card ({CFG4_BLOCKS} "
              f"blocks)")
    t0 = time.perf_counter()
    try:
        parts4, cfg4_index = config4(results)
        parts.update(parts4)
        results["config4"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 11 took {results['config4']['seconds']:.1f} s "
            f"({card})")
        # 12h reads phase 11's plane and index
        phase_log("phase 12: the ported scripts (scripts/torch_*.py) on "
                  "the card")
        t0 = time.perf_counter()
        parts.update(scripts_phase(results, cfg4_index))
        del cfg4_index
        results["scripts"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 12 took {results['scripts']['seconds']:.1f} s "
            f"({card})")
    finally:
        shutil.rmtree(CFG4_TMP, ignore_errors=True)
        shutil.rmtree(SCRIPTS_TMP, ignore_errors=True)
    # each path and part ran with the counts set to 0 just before it
    results["launches"] = {"main": launches, "path_a": launches_a,
                           "path_b": launches_b}
    for part, (part_launches, part_routes) in parts.items():
        results["launches"][part] = part_launches
        results["routes"][part] = part_routes
    launches = {name: sum(p[name] for p in results["launches"].values())
                for name in launches}
    results["seconds"] = time.perf_counter() - t_start
    log("detail " + json.dumps(results))

    def entry(name, source, replaces, headline, cases):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(c["max_abs_err"] for c in cases),
               "ms": headline["ms"], "plain_ms": headline["plain_ms"],
               "bound_ms": headline["bound_ms"],
               "bound_by": headline["bound_by"],
               "library_ms": headline["library_ms"]}
        for key in ("ms_warm", "ms_cold"):    # the ADC kernels' L2 states
            if key in headline:
                out[key] = headline[key]
        # which kernel of the wrapper ran (main path, paths A and B)
        by_route = {key.split(":")[1]: sum(r[key] for r in
                                           results["routes"].values())
                    for key in results["routes"]["main"]
                    if key.startswith(name + ":")}
        if by_route:
            out["routes"] = by_route
        return out

    kernels = [
        entry("fused_topk", "archi_tpu_torch/csrc/fused_topk.cu",
              "archi_tpu/ops/pallas_topk.py:261", topk[0], topk),
        entry("encoder_attention", "archi_tpu_torch/csrc/encoder_attention.cu",
              "archi_tpu/ops/pallas_attention.py:97", attn[0], attn),
        entry("adc_scores", "archi_tpu_torch/csrc/adc.cu",
              "archi_tpu/ops/pallas_adc.py:58", adc8[0], adc8),
        entry("adc_scores_lut16", "archi_tpu_torch/csrc/adc.cu",
              "archi_tpu/ops/pallas_adc.py:112", adc4[0], adc4),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
