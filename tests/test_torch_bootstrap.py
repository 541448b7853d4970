"""The port's bootstrap and embedder registry
(``archi_tpu_torch/bin/bootstrap.py``, ``archi_tpu_torch/models/registry.py``)
against the JAX package's ``archi_tpu/bin/bootstrap.py`` and
``archi_tpu/models/registry.py``.

- every registry name resolves to the port's class for it; the hash
  embedders give outputs identical to the JAX package's;
- ``build_index`` gives each of the five single-device types the
  constructor values of the JAX ``_build_index`` for the same config, and
  the two multi-device types (``sharded``, ``ivfpq_xl_sharded``) the JAX
  values over the same number of shards (``devices=["cpu"] * 8`` against
  the 8-device CPU mesh); without CUDA they raise unless given devices;
- ``build_vectorstore`` restores an ``engine_checkpoint`` the JAX store
  wrote (flat, hot_tail, ivf, ivfpq) and serves its results (f32 rows,
  1e-5, tie-aware), turns on micro-batching from the config, and raises
  without CUDA unless given ``device="cpu"``.
"""

import os

import numpy as np
import pytest
import torch

from archi_tpu.bin import bootstrap as jboot
from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models import registry as jreg
from archi_tpu.models.hashed_embedder import HashedNgramEmbedder as JNgram
from archi_tpu_torch.bin.bootstrap import build_index, build_vectorstore
from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex
from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
from archi_tpu_torch.engine.xl_index import XlPQIndex
from archi_tpu_torch.models import registry
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder

TEXTS = ["the quick brown fox jumps", "Scheduler-scheduling of GPU queues!",
         "", "déjà vu — unicode words", "storage quota 42 a b c"]


# ------------------------------------------------------------------ registry
@pytest.mark.parametrize("name", ["jax", "huggingface",
                                  "HuggingFaceEmbeddings", "minilm", "bge",
                                  "tpu"])
def test_encoder_names_resolve_to_torch_embedder(name, monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)

    monkeypatch.setattr(registry, "TorchEmbedder", Recorder)
    emb = registry.resolve_embedder(
        {"embedding_name": name, "model_dir": "/models/x",
         "embedding_kwargs": {"max_length": 128, "pooling": "cls"}},
        device="cpu")
    assert isinstance(emb, Recorder)
    assert seen == {"model_dir": "/models/x", "max_length": 128,
                    "instruction_prefix": "", "pooling": "cls",
                    "device": "cpu"}


def test_default_name_builds_the_encoder_on_the_given_device():
    emb = registry.resolve_embedder({}, device="cpu")   # embedding_class jax
    assert isinstance(emb, TorchEmbedder) and emb.dim == 384
    assert emb.device == torch.device("cpu") and emb.max_length == 256


@pytest.mark.parametrize("name,cls", [
    ("hash", registry.HashEmbeddings), ("fake", registry.HashEmbeddings),
    ("test", registry.HashEmbeddings), ("hashed_ngram", HashedNgramEmbedder),
    ("featurizer", HashedNgramEmbedder)])
def test_offline_embedders_match_jax(name, cls):
    cfg = {"embedding_class": name, "embedding_kwargs": {"dim": 48}}
    got, want = registry.resolve_embedder(cfg), jreg.resolve_embedder(cfg)
    assert type(got) is cls and got.dim == want.dim == 48
    assert np.array_equal(np.asarray(got.embed_documents(TEXTS), np.float32),
                          np.asarray(want.embed_documents(TEXTS), np.float32))
    assert got.embed_query(TEXTS[1]) == want.embed_query(TEXTS[1])


def test_hashed_ngram_embedder_matches_jax():
    t, j = HashedNgramEmbedder(dim=64, char_weight=0.3), \
        JNgram(dim=64, char_weight=0.3)
    assert np.array_equal(t.encode_numpy(TEXTS), j.encode_numpy(TEXTS))
    assert t.encode_numpy([]).shape == (0, 64)
    assert t.instruction_prefix == j.instruction_prefix == ""


def test_openai_embeddings_and_secret(monkeypatch, tmp_path):
    monkeypatch.setenv("OPENAI_API_KEY", "from-env")
    cfg = {"embedding_name": "openai",
           "embedding_kwargs": {"base_url": "http://localhost:1/v1/"}}
    got, want = registry.resolve_embedder(cfg), jreg.resolve_embedder(cfg)
    assert type(got) is registry.OpenAIEmbeddings
    assert vars(got) == vars(want)
    assert got.api_key == "from-env" and got.base_url.endswith("/v1")
    secret = tmp_path / "key"
    secret.write_text("from-file\n")
    monkeypatch.setenv("OPENAI_API_KEY_FILE", str(secret))
    assert registry.read_secret("OPENAI_API_KEY") == "from-file"
    monkeypatch.delenv("OPENAI_API_KEY_FILE")
    monkeypatch.delenv("OPENAI_API_KEY")
    assert registry.read_secret("OPENAI_API_KEY") is None


def test_unknown_embedder_raises():
    with pytest.raises(ValueError, match="unknown embedding class"):
        registry.resolve_embedder({"embedding_name": "nope"})


# --------------------------------------------------------------- build_index
_SCALARS = (bool, int, float, str, type(None))


def _settings(idx, keys=None) -> dict:
    """The constructor values an index keeps, by attribute name (``keys``:
    read exactly these, properties included)."""
    if keys is None:
        keys = [k for k, v in vars(idx).items()
                if not k.startswith("_") and isinstance(v, _SCALARS)]
        keys += ["dtype", "class"]
        keys += [f"{part}.{a}" for part in ("main", "tail")
                 for a in ("tile_n", "capacity") if hasattr(idx, part)]
        keys += ["store.path"] if hasattr(idx, "store") else []
    out = {}
    for key in keys:
        if key == "class":
            out[key] = type(idx).__name__
        elif key == "dtype":
            out[key] = str(idx.dtype).replace("torch.", "")
        else:
            obj = idx
            for part in key.split("."):
                obj = getattr(obj, part)
            out[key] = obj
    return out


CONFIGS = {
    "flat": {},
    "flat_f32": {"type": "flat", "dtype": "float32", "tile_n": 256},
    "hot_tail": {"hot_tail": True},
    "hot_tail_small": {"hot_tail": True, "merge_rows": 64, "tile_n": 512},
    "ivf": {"type": "ivf"},
    "ivfpq": {"type": "ivfpq"},
    "ivfpq_tuned": {"type": "ivfpq", "nlist": 8, "nprobe": 4,
                    "nprobe_blocks": 16, "cell_gate": 2, "block_rank_sub": 2,
                    "min_snapshot_rows": 16, "pq_m": 8, "pq_refine_m": 0,
                    "extract": "hier", "hier_t": 32, "async_refresh": False},
    "ivfpq_xl": {"type": "ivfpq_xl"},
    "ivfpq_xl_tuned": {"type": "ivfpq_xl", "nlist": 8, "block": 128,
                       "pq_m": 8, "pq_refine_m": 8, "nprobe_blocks": 0,
                       "cell_gate": 4, "block_rank_sub": 2,
                       "rerank_overfetch": 4, "min_snapshot_rows": 4096,
                       "async_refresh": False, "dtype": "float32"},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_index_matches_jax_defaults(name, tmp_path):
    cfg = dict(CONFIGS[name])
    if cfg.get("type") == "ivfpq_xl" and name.endswith("tuned"):
        cfg["store_path"] = str(tmp_path / "plane.bin")
    want = _settings(jboot._build_index(32, cfg))
    got = _settings(build_index(32, cfg, device="cpu"), list(want))
    assert got == want
    assert got["class"] in {"FlatIndex", "SegmentedFlatIndex",
                            "AnnFlatIndex", "XlPQIndex"}


def test_build_index_types():
    assert type(build_index(8, {}, device="cpu")) is FlatIndex
    assert isinstance(build_index(8, {"hot_tail": True}, device="cpu"),
                      SegmentedFlatIndex)
    for kind in ("ivf", "ivfpq"):
        idx = build_index(8, {"type": kind}, device="cpu")
        assert isinstance(idx, AnnFlatIndex) and idx.snapshot_kind == kind
    xl = build_index(8, {"type": "ivfpq_xl"}, device="cpu")
    assert isinstance(xl, XlPQIndex) and xl.async_refresh


SHARDED = {
    "sharded": {"type": "sharded"},
    "sharded_f32": {"type": "sharded", "dtype": "float32", "tile_n": 256},
    "ivfpq_xl_sharded": {"type": "ivfpq_xl_sharded"},
    "ivfpq_xl_sharded_tuned": {
        "type": "ivfpq_xl_sharded", "nlist": 8, "block": 128, "pq_m": 8,
        "pq_refine_m": 8, "nprobe_blocks": 0, "cell_gate": 4,
        "block_rank_sub": 2, "rerank_overfetch": 4, "extract": "hier",
        "hier_t": 32, "min_snapshot_rows": 4096, "build_block_rows": 2048,
        "dtype": "float32", "tile_n": 512},
}


@pytest.mark.parametrize("name", list(SHARDED))
def test_build_index_sharded_types_match_jax_defaults(name, tmp_path):
    cfg = dict(SHARDED[name])
    if name.endswith("tuned"):
        cfg["store_dir"] = str(tmp_path / "planes")
    want_idx = jboot._build_index(32, cfg)
    got_idx = build_index(32, cfg, devices=["cpu"] * 8)
    keys = ["class", "dtype", "dim", "tile_n", "normalize", "metric",
            "n_shards", "capacity", "n_rows"]
    if cfg["type"] == "ivfpq_xl_sharded":
        keys = ["class", "dim", "normalize", "n_shards", "store_dir",
                "capacity", "n_rows"]
        # every shard is an XlPQIndex with the JAX shard's settings
        want_shard = _settings(want_idx.shards[0])
        assert _settings(got_idx.shards[0], list(want_shard)) == want_shard
        assert [s.store.path for s in got_idx.shards] == \
            [s.store.path for s in want_idx.shards]
    assert _settings(got_idx, keys) == _settings(want_idx, keys)
    assert got_idx.n_shards == 8
    assert type(got_idx) in (ShardedFlatIndex, ShardedXlPQIndex)


@pytest.mark.parametrize("kind", ["sharded", "ivfpq_xl_sharded"])
def test_multi_device_types_raise(kind, monkeypatch):
    """Without CUDA the multi-device types raise unless the caller names
    the devices (or the CPU); with ``device="cpu"`` alone they hold one
    shard there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(32, {"type": kind})
    assert build_index(32, {"type": kind}, device="cpu").n_shards == 1
    assert build_index(32, {"type": kind},
                       devices=["cpu"] * 3).n_shards == 3


# ---------------------------------------------------------- build_vectorstore
DIM = 32
CORPUS = [f"chunk {i} about {'batch schedulers' if i % 2 else 'storage'} "
          f"topic{i % 6} word{i}" for i in range(48)]
QUERIES = ["batch schedulers", "storage topic3", "word17 chunk",
           "nothing matches zzz"]


def _dm(tmp_path, index_cfg, **extra):
    return {"embedding_name": "hash", "embedding_kwargs": {"dim": DIM},
            "data_path": str(tmp_path / "data"),
            "db_path": str(tmp_path / "catalog.db"),
            "index": index_cfg, **extra}


RESTORE = {
    "flat": {"dtype": "float32"},
    "hot_tail": {"hot_tail": True, "merge_rows": 16, "dtype": "float32"},
    "ivf": {"type": "ivf", "nlist": 4, "nprobe": 4, "min_snapshot_rows": 16,
            "async_refresh": False, "dtype": "float32"},
    "ivfpq": {"type": "ivfpq", "nlist": 4, "nprobe": 4, "pq_m": 8,
              "pq_refine_m": 8, "min_snapshot_rows": 16,
              "async_refresh": False, "dtype": "float32"},
}


def _assert_same(got, want, tol=1e-5):
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)
    g = {d.metadata["chunk_id"]: s for d, s in got}
    w = {d.metadata["chunk_id"]: s for d, s in want}
    cut = min(w.values())
    assert all(abs(g.get(c, w.get(c)) - cut) <= tol for c in set(g) ^ set(w))


@pytest.mark.parametrize("kind", list(RESTORE))
def test_restores_a_checkpoint_the_jax_store_wrote(kind, tmp_path):
    dm = _dm(tmp_path, RESTORE[kind])
    js = TpuVectorStore(jreg.HashEmbeddings(DIM),
                        index=jboot._build_index(DIM, dm["index"]))
    js.add_texts(CORPUS, [{"i": i} for i in range(48)],
                 ids=[f"c{i}" for i in range(48)])
    js.delete(["c5"]) if kind in ("flat", "hot_tail") else None
    js.hybrid_search("storage", k=3)   # builds the ANN snapshot
    ckpt = os.path.join(dm["data_path"], "engine_checkpoint")
    js.save(ckpt)
    if kind in ("ivf", "ivfpq"):
        assert os.path.exists(os.path.join(ckpt, "index.npz.ann.npz"))
    ts = build_vectorstore(dm, device="cpu")
    # the JAX package's own restore of the same checkpoint (a restored IVF
    # snapshot holds bf16 blocks in both packages)
    jr = jboot.build_context(overrides={"data_manager": dm}).vectorstore
    expected = {"flat": FlatIndex, "hot_tail": SegmentedFlatIndex,
                "ivf": AnnFlatIndex, "ivfpq": AnnFlatIndex}[kind]
    assert type(ts.index) is expected and type(jr.index).__name__ == \
        expected.__name__
    assert ts.count() == jr.count() == js.count()
    if kind in ("ivf", "ivfpq"):
        assert ts.index._ivf is not None and ts.index.snapshot_kind == kind
    assert ts._batcher is None
    for q in QUERIES:
        _assert_same(ts.hybrid_search(q, k=5), jr.hybrid_search(q, k=5))
        _assert_same(ts.similarity_search_with_score(q, k=5),
                     jr.similarity_search_with_score(q, k=5))
        if kind in ("flat", "hot_tail"):
            _assert_same(ts.hybrid_search(q, k=5), js.hybrid_search(q, k=5))
    assert ts.add_texts(["a new chunk"]) == ["default:0"]


def test_fresh_store_when_no_checkpoint(tmp_path):
    dm = _dm(tmp_path, {"hot_tail": True}, stemming={"enabled": True})
    ts = build_vectorstore(dm, device="cpu")
    assert isinstance(ts.index, SegmentedFlatIndex) and ts.count() == 0
    assert ts.bm25.stemming and ts.device == torch.device("cpu")


def test_broken_checkpoint_builds_afresh(tmp_path, caplog):
    dm = _dm(tmp_path, {})
    ckpt = os.path.join(dm["data_path"], "engine_checkpoint")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "index.npz"), "w") as f:
        f.write("not an npz")
    ts = build_vectorstore(dm, device="cpu")
    assert ts.count() == 0 and "did not restore" in caplog.text


@pytest.mark.parametrize("mb,want", [
    ({"enabled": True}, (32, 0.004, 2)),
    ({"enabled": True, "max_batch": 8, "max_wait_ms": 1.5, "workers": 3},
     (8, 0.0015, 3)),
    ({"enabled": False}, None), (None, None)])
def test_micro_batch_config(tmp_path, mb, want):
    dm = _dm(tmp_path, {}, serving={"micro_batch": mb})
    ts = build_vectorstore(dm, device="cpu")
    try:
        if want is None:
            assert ts._batcher is None
        else:
            b = ts._batcher
            assert (b.max_batch, b.max_wait_s, len(b._workers)) == want
            ts.add_texts(CORPUS[:8])
            assert ts.hybrid_search("storage", k=2)
    finally:
        if ts._batcher is not None:
            ts._batcher.close()


def test_bootstrap_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dm = _dm(tmp_path, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_vectorstore(dm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(DIM, {})
    assert build_vectorstore(dm, device="cpu").count() == 0
