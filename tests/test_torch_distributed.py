"""The port's process-group helpers and the sharded search across two
processes: the counterpart of ``tests/integration/test_multihost.py`` /
``mh_child.py``.

- ``initialize_distributed`` is a no-op on a single host and reads
  COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID as the JAX package does;
  ``data_mesh`` / ``dp_tp_mesh`` give device lists of the JAX meshes'
  shapes.
- Two processes join a gloo group, each holding 4 CPU shards of an
  8-shard corpus (shards 4r .. 4r + 3 on rank r).  The children are this
  file run as a script; they import no JAX.  They run mh_child's checks
  through ``sharded_search`` (brute force, growth, a tombstone and a hybrid
  boost on opposite ranks, short shards with k = 20) and a
  ``ShardedFlatIndex`` over the group (adds that grow it and move rows
  between the ranks, deletes, filter and per-query bias).  The parent holds
  their output against JAX ``_sharded_search`` and ``ShardedFlatIndex`` on
  the 8-device mesh with the same inputs: rows equal, scores within 1e-6.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from archi_tpu_torch.engine import distributed
from archi_tpu_torch.engine.distributed import (data_mesh, dp_tp_mesh,
                                                initialize_distributed,
                                                process_group)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, B, K = 4096, 64, 4, 10
N2, NS, LIVE, KS = 6144, 128, 24, 20
BOOSTED = 4 * (N2 // 8) + 5          # owned by rank 1
INDEX_TILE = 128


def _inputs():
    """mh_child's inputs, from the same seed and in the same order."""
    rng = np.random.default_rng(0)
    full = rng.standard_normal((N, D)).astype(np.float32)
    full /= np.linalg.norm(full, axis=1, keepdims=True)
    q_rows = np.array([7, 1234, 2048, 4000])
    q = full[q_rows] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    grown = np.zeros((N2, D), np.float32)
    grown[:N] = full
    fresh = rng.standard_normal((1024, D)).astype(np.float32)
    fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
    grown[N:N + 1024] = fresh
    fq = fresh[37:38] + 0.01 * rng.standard_normal((1, D)).astype(np.float32)
    fq /= np.linalg.norm(fq)
    dead = 7                                  # row 7, owned by rank 0
    bias_h = np.zeros((N2,), np.float32)
    bias_h[BOOSTED] = 10.0
    bias_h[dead] = np.float32(-1e30)
    small = np.zeros((NS, D), np.float32)
    small[:LIVE] = full[:LIVE]
    qb = (0.05 * rng.random((B, 5000))).astype(np.float32)
    qb[np.arange(B), [100, 1500, 2600, 4900]] = 3.0     # both ranks
    fm = (rng.random(5000) > 0.2).astype(np.float32)
    return dict(full=full, q=q, q_rows=q_rows, grown=grown, fq=fq,
                bias_h=bias_h, dead=dead, small=small, qb=qb, fm=fm)


CASES = ("brute", "growth", "fresh", "short")


def _case_args(x, case):
    """(queries, corpus, bias, n_live, k, JAX tile_n) of one check."""
    if case == "brute":
        return x["q"], x["full"], np.zeros((N,), np.float32), N, K, 512
    if case == "growth":
        return x["q"], x["grown"], x["bias_h"], N + 1024, K, 512
    if case == "fresh":
        return (x["fq"], x["grown"], np.zeros((N2,), np.float32), N + 1024,
                1, 512)
    return x["q"][:1], x["small"], np.zeros((NS,), np.float32), LIVE, KS, 16


INDEX_BLOCKS = (1000, 700, 2300, 1000)    # three growths, seams crossed


def _index_calls(idx, x):
    """The same adds, deletes and searches on a sharded index of either
    package → a list of (vals, rows)."""
    rows = x["grown"]                     # 5120 rows in use
    s0 = 0
    for n in INDEX_BLOCKS:
        idx.add(rows[s0:s0 + n], [f"r{i}" for i in range(s0, s0 + n)])
        s0 += n
    idx.delete(["r7", "r3000", "r4095"])
    out = []
    for kw in ({}, {"bias": x["qb"]}, {"filter_mask": x["fm"]},
               {"filter_mask": x["fm"][:2500], "bias": x["qb"][0]}):
        _ids, vals, r = idx.search(x["q"], k=K, **kw)
        out.append((np.asarray(vals), np.asarray(r)))
    return out


# ------------------------------------------------------------------- child
def _child(out_path: str) -> None:
    import torch.distributed as dist

    from archi_tpu_torch.engine.sharded_index import (ShardedFlatIndex,
                                                      sharded_search)

    initialize_distributed(device="cpu")     # from the environment
    group, world, rank = process_group()
    assert world == 2 and rank == int(os.environ["PROCESS_ID"])
    assert dist.get_backend() == "gloo"
    x = _inputs()
    res = {}
    try:
        for case in CASES:
            q, corpus, bias, live, k, _tile = _case_args(x, case)
            sc = corpus.shape[0] // 8
            mine = range(4 * rank, 4 * rank + 4)
            v, r = sharded_search(
                torch.from_numpy(q),
                [torch.from_numpy(corpus[s * sc:(s + 1) * sc]) for s in mine],
                [torch.from_numpy(bias[s * sc:(s + 1) * sc]) for s in mine],
                live, k=k, first_shard=4 * rank, group=group)
            res[f"{case}_vals"], res[f"{case}_rows"] = v.numpy(), r.numpy()
        idx = ShardedFlatIndex(D, devices=["cpu"] * 4, dtype="float32",
                               tile_n=INDEX_TILE)
        assert (idx.n_shards, idx.first_shard) == (8, 4 * rank)
        for i, (v, r) in enumerate(_index_calls(idx, x)):
            res[f"index{i}_vals"], res[f"index{i}_rows"] = v, r
        res["index_capacity"] = np.asarray(idx.capacity)
        res["index_alive"] = idx.alive.numpy()
    finally:
        dist.destroy_process_group()
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "archi_tpu")]
    np.savez(out_path, **res)
    print(f"TORCH_MH_OK rank={rank}", flush=True)


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Run the two ranks; → their npz outputs by rank."""
    tmp = tmp_path_factory.mktemp("torch_mh")
    port = _free_port()
    procs, outs = [], []
    for rank in (0, 1):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""), OMP_NUM_THREADS="1")
        outs.append(str(tmp / f"rank{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), outs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"TORCH_MH_OK rank={rank}" in log, log
        assert "jax" not in log.lower()
    return [dict(np.load(o)) for o in outs]


def test_children_import_no_jax():
    code = ("import sys, tests.test_torch_distributed as t; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'archi_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT), check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("case", CASES)
def test_two_process_search_matches_jax_sharded_search(children, case):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from archi_tpu.engine.sharded_index import _sharded_search, default_mesh

    assert len(jax.devices()) == 8
    x = _inputs()
    q, corpus, bias, live, k, tile = _case_args(x, case)
    mesh = default_mesh()
    jv, jr = _sharded_search(
        jax.device_put(q), jax.device_put(corpus, NamedSharding(mesh, P(
            "data", None))), jax.device_put(bias, NamedSharding(mesh, P(
                "data"))), np.int32(live), mesh=mesh, axis="data", k=k,
        tile_n=tile, impl="xla")
    jv, jr = np.asarray(jv), np.asarray(jr)
    for out in children:              # every rank returns the same answer
        np.testing.assert_allclose(out[f"{case}_vals"], jv, rtol=0,
                                   atol=1e-6)
        assert (out[f"{case}_rows"] == jr).all()
    got = children[0][f"{case}_rows"]
    if case == "brute":
        exact = np.argsort(-(q @ x["full"].T), axis=1)[:, :K]
        assert (np.sort(got, 1) == np.sort(exact, 1)).all()
        assert (got[:, 0] == x["q_rows"]).all()
    elif case == "growth":
        assert (got[:, 0] == BOOSTED).all()
        assert x["dead"] not in set(got.reshape(-1).tolist())
    elif case == "fresh":
        assert int(got[0, 0]) == N + 37
    else:
        vals = children[0][f"{case}_vals"]
        hits = got[0][vals[0] > -1e29]
        exact = np.argsort(-(q @ x["small"][:LIVE].T), axis=1)[0][:KS]
        assert len(hits) == KS and set(hits.tolist()) == set(exact.tolist())


def test_two_process_index_matches_jax_sharded_index(children):
    from archi_tpu.engine.sharded_index import ShardedFlatIndex as JSharded

    x = _inputs()
    j = JSharded(D, dtype=np.float32, tile_n=INDEX_TILE)
    want = _index_calls(j, x)
    for out in children:
        assert int(out["index_capacity"]) == j.capacity
        np.testing.assert_array_equal(out["index_alive"], np.asarray(j.alive))
        for i, (wv, wr) in enumerate(want):
            np.testing.assert_allclose(out[f"index{i}_vals"], wv, rtol=0,
                                       atol=1e-6)
            live = wv > -1e29
            assert (out[f"index{i}_rows"][live] == wr[live]).all()
    assert [int(r[0]) for r in want[1][1]] == [100, 1500, 2600, 4900]


# ----------------------------------------------------------------- helpers
def test_initialize_is_a_no_op_on_a_single_host(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **k: pytest.fail("joined a group"))
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert process_group() == (None, 1, 0)


@pytest.mark.parametrize("env,args,want", [
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "2"}, {}, ("gloo", "tcp://10.0.0.1:1234", 4, 2)),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "4",
      "PROCESS_ID": "2"}, {"coordinator_address": "g:9", "num_processes": 2,
                           "process_id": 1}, ("gloo", "tcp://g:9", 2, 1)),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:5"}, {"device": "cuda"},
     ("nccl", "tcp://127.0.0.1:5", 1, 0)),
])
def test_initialize_reads_the_environment(monkeypatch, env, args, want):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    seen = []
    monkeypatch.setattr(
        distributed.dist, "init_process_group",
        lambda backend, **kw: seen.append(
            (backend, kw["init_method"], kw["world_size"], kw["rank"])))
    initialize_distributed(**{"device": "cpu", **args})
    assert seen == [want]


def test_many_processes_need_an_address(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        initialize_distributed(num_processes=2, process_id=0, device="cpu")


def test_device_lists(monkeypatch):
    assert data_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    grid = dp_tp_mesh(2, devices=["cpu"] * 8)
    assert [len(r) for r in grid] == [2, 2, 2, 2]
    assert dp_tp_mesh(devices=["cpu"] * 4) == [[torch.device("cpu")]] * 4
    with pytest.raises(AssertionError):
        dp_tp_mesh(3, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert data_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_fetch_reads_cpu_tensors_as_arrays():
    a, b = torch.arange(6).reshape(2, 3), torch.ones(4)
    out = distributed.fetch([a, b])
    assert [o.tolist() for o in out] == [a.tolist(), b.tolist()]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _child(sys.argv[1])
