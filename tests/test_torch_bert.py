"""The port's encoder, weight loading and embedder against the JAX package.

Weights are drawn once by the JAX package's ``init_params`` and carried
across with ``params_from_jax``; the HF path builds a tiny
``transformers.BertModel`` locally (no download).  Tolerance rtol 1e-4.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.models import bert as jbert
from archi_tpu.models import hf_loader as jhf
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch.models import bert as tbert
from archi_tpu_torch.models import hf_loader as thf
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

RTOL = 1e-4
TEXTS = ["the quick brown fox jumps over the lazy dog",
         "retrieval augmented generation",
         "a much longer sentence about hybrid search " * 12,
         "dog"]


def _cfg(pooling="mean", heads=2, **kw):
    return dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=heads,
                intermediate_size=128, max_position_embeddings=128,
                pooling=pooling, **kw)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _ids_mask(seed=0, b=4, s=24, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, 9:] = 0
    mask[-1, 4:] = 0
    return ids, mask


def _port_encode(state, cfg, ids, mask):
    model = tbert.BertEncoder.from_state(cfg, state, device="cpu")
    return tbert.encode(model, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask).long()).numpy()


def test_init_params_draws_the_reference_values():
    for pooling in ("mean", "attn"):
        jcfg = jbert.BertConfig(**_cfg(pooling))
        tcfg = tbert.BertConfig(**_cfg(pooling))
        want = _tree_np(jbert.init_params(jcfg, seed=7))
        got = tbert.init_params(tcfg, seed=7)
        for group in want:
            for name in want[group]:
                np.testing.assert_array_equal(got[group][name],
                                              want[group][name])


@pytest.mark.parametrize("pooling,heads", [("mean", 2), ("cls", 4),
                                           ("attn", 2)])
def test_encode_matches_jax(pooling, heads):
    jcfg = jbert.BertConfig(**_cfg(pooling, heads))
    tree = _tree_np(jbert.init_params(jcfg, seed=1))
    if pooling == "attn":  # a non-trivial token gate
        tree["pool_attn"]["w"] = np.random.default_rng(5).standard_normal(
            64).astype(np.float32)
    ids, mask = _ids_mask()
    want = np.asarray(jbert.encode(tree, ids, mask, jcfg))
    got = _port_encode(thf.params_from_jax(tree),
                       tbert.BertConfig(**_cfg(pooling, heads)), ids, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_encode_matches_jax_pallas_attention():
    """Against the JAX encoder running its Pallas attention (interpret)."""
    jcfg = jbert.BertConfig(**_cfg())
    tree = _tree_np(jbert.init_params(jcfg, seed=2))
    ids, mask = _ids_mask(1, b=2, s=32)
    want = np.asarray(jbert.encode(tree, ids, mask, jcfg,
                                   attention_impl="pallas",
                                   attention_interpret=True))
    got = _port_encode(thf.params_from_jax(tree), tbert.BertConfig(**_cfg()),
                       ids, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_encode_tokens_matches_jax():
    jcfg = jbert.BertConfig(**_cfg())
    tree = _tree_np(jbert.init_params(jcfg, seed=3))
    ids, mask = _ids_mask(2)
    want = np.asarray(jbert.encode_tokens(tree, ids, mask, jcfg))
    model = tbert.BertEncoder.from_state(
        tbert.BertConfig(**_cfg()), thf.params_from_jax(tree), device="cpu")
    got = tbert.encode_tokens(model, torch.from_numpy(ids).long(),
                              torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("pooling", ["mean", "attn"])
def test_padding_invariance(pooling):
    cfg = tbert.BertConfig(**_cfg(pooling))
    state = thf.params_from_jax(tbert.init_params(cfg, seed=4))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 300, 10)
    outs = []
    for s in (16, 64):
        ids = np.zeros((1, s), np.int32)
        mask = np.zeros((1, s), np.int32)
        ids[0, :10], mask[0, :10] = toks, 1
        outs.append(_port_encode(state, cfg, ids, mask))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=300, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=128, type_vocab_size=2)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg, add_pooling_layer=False).eval()
    return cfg, model


def test_hf_state_dict_matches_jax_and_transformers(tiny_hf):
    hf_cfg, model = tiny_hf
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    kw = _cfg(heads=4, normalize=False)
    jcfg, tcfg = jbert.BertConfig(**kw), tbert.BertConfig(**kw)
    ids, mask = _ids_mask(3)
    want = np.asarray(jbert.encode(jhf.params_from_state_dict(sd, jcfg),
                                   ids, mask, jcfg))
    got = _port_encode(thf.params_from_state_dict(sd, tcfg), tcfg, ids, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long()
                   ).last_hidden_state.numpy()
    m = mask[:, :, None].astype(np.float32)
    np.testing.assert_allclose(got, (hf * m).sum(1) / m.sum(1),
                               rtol=2e-4, atol=2e-4)


def test_snapshot_dir_loads_alike_in_both_packages(tiny_hf, tmp_path):
    hf_cfg, model = tiny_hf
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    JaxTokenizer.build_vocab(TEXTS, size=300).save_vocab(
        str(tmp_path / "vocab.txt"))
    jemb = JaxEmbedder(str(tmp_path), compute_dtype=jnp.float32,
                       attention_impl="xla")
    temb = TorchEmbedder(str(tmp_path), device="cpu")
    assert temb.config == tbert.BertConfig(**_cfg(heads=4))
    np.testing.assert_allclose(temb.encode_numpy(TEXTS),
                               jemb.encode_numpy(TEXTS), rtol=RTOL, atol=1e-5)


def _embedders(*, jax_kw=None, devices=None, **kw):
    jtok = JaxTokenizer.build_vocab(TEXTS)
    ttok = WordPieceTokenizer(dict(jtok.vocab))
    jemb = JaxEmbedder(config=jbert.BertConfig(**_cfg()), tokenizer=jtok,
                       compute_dtype=jnp.float32, attention_impl="xla",
                       **kw, **(jax_kw or {}))
    temb = TorchEmbedder(config=tbert.BertConfig(**_cfg()), tokenizer=ttok,
                         device="cpu", devices=devices, **kw)
    return jemb, temb


def test_embedder_matches_jax_embedder():
    jemb, temb = _embedders()
    np.testing.assert_allclose(np.asarray(temb.embed_documents(TEXTS)),
                               np.asarray(jemb.embed_documents(TEXTS)),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(temb.encode_numpy(TEXTS), axis=1),
                               1.0, rtol=1e-5)


def test_embedder_query_prefix_and_empty_input():
    jemb, temb = _embedders(instruction_prefix="query: ")
    np.testing.assert_allclose(temb.embed_query("what is a fox"),
                               jemb.embed_query("what is a fox"),
                               rtol=RTOL, atol=1e-5)
    assert temb.embed_documents([]) == []
    assert temb.encode_numpy([]).shape == (0, 64)


def test_batch_composition_invariance():
    _, temb = _embedders()
    solo = temb.encode_numpy([TEXTS[0]])
    batch = temb.encode_numpy(TEXTS[2:] + [TEXTS[0]] * 9)
    np.testing.assert_allclose(solo[0], batch[-1], rtol=1e-5, atol=1e-6)


def test_pad_batch_buckets_and_masks():
    _, temb = _embedders()
    ids, mask = temb._pad_batch([[1, 2, 3], [4] * 70])
    assert ids.shape == (8, 128) and mask.shape == (8, 128)
    assert mask[2:].sum() == 0 and mask[0].sum() == 3 and mask[1].sum() == 70


@pytest.mark.parametrize("n_dev", [2, 3])
def test_data_parallel_encode_matches_jax_mesh_embedder(n_dev):
    """``devices=`` splits each padded batch over the devices (a device may
    repeat), as the JAX embedder's ``mesh=`` does over the 8-device CPU
    mesh: the same outputs, and batches padded to a multiple of the
    device count."""
    import jax

    from archi_tpu.engine.distributed import data_mesh

    mesh = data_mesh(devices=jax.devices()[:n_dev])
    jemb, temb = _embedders(devices=["cpu"] * n_dev, jax_kw={"mesh": mesh})
    texts = TEXTS * 3 + ["one more"]            # 13: not a multiple of n
    np.testing.assert_allclose(temb.encode_numpy(texts),
                               jemb.encode_numpy(texts), rtol=RTOL,
                               atol=1e-5)
    ids, _mask = temb._pad_batch([[1]] * 9)
    jids, _jmask = jemb._pad_batch([[1]] * 9)
    assert ids.shape == jids.shape and ids.shape[0] % n_dev == 0
    _, single = _embedders()
    np.testing.assert_allclose(temb.encode_numpy(texts),
                               single.encode_numpy(texts), rtol=1e-5,
                               atol=1e-6)
    assert len(temb._replicas) == 1 and temb.devices == [
        torch.device("cpu")] * n_dev
