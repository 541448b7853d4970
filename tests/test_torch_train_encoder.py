"""The port's encoder trainer (``archi_tpu_torch.models.train_encoder``)
against the JAX package's.

- the copied pair mining and vocabulary give the JAX package's lists;
- one f32 step from the same parameters gives the JAX loss (rtol 1e-4) and
  gradients (rtol 1e-4, atol 1e-6) of ``jax.value_and_grad`` over
  ``archi_tpu.models.bert.encode``; after 3 steps AdamW with the cosine
  schedule gives ``optax.adamw``'s parameters (atol 2e-4);
- ``train`` at its default bf16 draws the JAX ``train``'s batches and its
  loss curve stays within 2e-2 relative;
- the trained encoder retrieves (the JAX test's check, at 0.75);
- the export round-trips and each package loads the other's snapshot (f32
  embeddings within 1e-5), the files byte-identical;
- the attention ``autograd.Function``: gradcheck in f64, and the plain
  version's autograd gradient at f32.
"""

import filecmp
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from archi_tpu.models import bert as jbert
from archi_tpu.models import hf_loader as jhf
from archi_tpu.models import train_encoder as jtrain
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch.models import bert as tbert
from archi_tpu_torch.models import hf_loader as thf
from archi_tpu_torch.models import train_encoder as ttrain
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.ops.attention import (differentiable_attention,
                                           plain_attention)

CORPUS = [
    "submit slurm array jobs with sbatch on the batch cluster partition",
    "gpu quota allocation increase request for the gpu partition",
    "xrootd transfer timeout when copying files with xrdcp redirector",
    "eos storage namespace quota exceeded mount fuse filesystem",
    "kubernetes pod eviction due to node memory pressure limits",
    "grafana dashboard provisioning with postgres datasource panels",
    "jira ticket workflow transitions and project permission schemes",
    "condor dagman workflow rescue dag after node failure resubmit",
] * 3
MINED = [
    "The Compact Muon Solenoid (CMS) records collisions. "
    "CMS data flows through the tier sites.",
    "WLCG (Worldwide Lhc Computing Grid) coordinates the sites.",
    "xrootd is a protocol for streaming remote files efficiently.",
    "The fair-share scheduler, also known as fairshare, balances jobs.",
    "A Mismatched Thing (NOPE) should not match initials.",
] * 2 + CORPUS
TINY = dict(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=64)
TRAIN = dict(vocab_size=2048, batch=16, seq_len=32, seed=0, log_every=0)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _jax_tree(state, cfg):
    """A port state (or gradients under its names) → the JAX parameter
    tree, through the HF naming both packages share."""
    sd = ttrain.state_dict_from_params(state, cfg)
    return _tree_np(jhf.params_from_state_dict(sd, jbert.BertConfig(**TINY)))


def _batch(seed=0, b=8, s=20):
    tok = JaxTokenizer.build_vocab(CORPUS, size=TINY["vocab_size"])
    rng = np.random.default_rng(seed)
    q = [tok.encode(" ".join(rng.choice(CORPUS[i].split(), 3)), 20)
         for i in range(b)]
    d = [tok.encode(CORPUS[i], 20) for i in range(b)]
    return (*jtrain._pad(q, s), *jtrain._pad(d, s))


def _jax_loss(params, batch, tau=0.05):
    cfg = jbert.BertConfig(**TINY)
    q_ids, q_mask, d_ids, d_mask = (jnp.asarray(a) for a in batch)
    zq = jbert.encode(params, q_ids, q_mask, cfg, compute_dtype=jnp.float32)
    zd = jbert.encode(params, d_ids, d_mask, cfg, compute_dtype=jnp.float32)
    logits = zq @ zd.T / tau
    labels = jnp.arange(logits.shape[0])
    return 0.5 * (
        optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        + optax.softmax_cross_entropy_with_integer_labels(
            logits.T, labels).mean())


def _port_model(seed=0):
    cfg = tbert.BertConfig(**TINY)
    state = thf.params_from_jax(
        _tree_np(jbert.init_params(jbert.BertConfig(**TINY), seed=seed)))
    return cfg, tbert.BertEncoder.for_training(cfg, state, device="cpu")


# ------------------------------------------------------------ data parity
def test_pairs_and_noise_match_jax():
    for seed in (0, 3):
        assert ttrain.make_pairs(CORPUS, np.random.default_rng(seed)) == \
            jtrain.make_pairs(CORPUS, np.random.default_rng(seed))
    noise = jtrain.noise_vocab(MINED, n_pseudo=16)
    assert ttrain.noise_vocab(MINED, n_pseudo=16) == noise
    assert ttrain.make_pairs(MINED, np.random.default_rng(1), noise=noise) \
        == jtrain.make_pairs(MINED, np.random.default_rng(1), noise=noise)
    excl = {"fairshare"}
    assert ttrain.mine_pairs(MINED) == jtrain.mine_pairs(MINED)
    assert ttrain.mine_pairs(MINED, exclude_terms=excl) == \
        jtrain.mine_pairs(MINED, exclude_terms=excl)
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    assert [ttrain._splice("a b c", noise, rng_t) for _ in range(20)] == \
        [jtrain._splice("a b c", noise, rng_j) for _ in range(20)]
    assert ttrain._trim_expansion("The Compact Muon Solenoid", "CMS") == \
        jtrain._trim_expansion("The Compact Muon Solenoid", "CMS")
    assert ttrain.small_config(100).__dict__ == \
        jtrain.small_config(100).__dict__


def test_pad_matches_jax():
    lists = [[2, 5, 6, 3], [2, 3], list(range(40))]
    for got, want in zip(ttrain._pad(lists, 16), jtrain._pad(lists, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 130])
def test_cosine_lr_matches_optax(step):
    sched = optax.cosine_decay_schedule(3e-4, 100, alpha=0.05)
    np.testing.assert_allclose(ttrain.cosine_lr(3e-4, 100, step),
                               float(sched(step)), rtol=1e-6)


# ------------------------------------------------------------ step parity
def test_f32_step_loss_and_gradients_match_jax():
    batch = _batch()
    cfg, model = _port_model()
    params = jbert.init_params(jbert.BertConfig(**TINY), seed=0)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss))(params,
                                                                   batch)
    loss = ttrain.contrastive_loss(
        model, *ttrain.to_batch(*batch, device="cpu"), tau=0.05)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = _jax_tree({n: p.grad for n, p in model.named_parameters()}, cfg)
    want = _tree_np(want_grads)
    for group in ("embeddings", "layers"):
        for name, w in want[group].items():
            np.testing.assert_allclose(got[group][name], w, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{group}.{name}")


def test_three_adamw_steps_match_optax():
    batches = [_batch(seed=s) for s in range(3)]
    steps, lr = 10, 3e-4                  # lr: the trainer's default
    params = jbert.init_params(jbert.BertConfig(**TINY), seed=0)
    opt = optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha=0.05),
                      weight_decay=0.01)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(_jax_loss))
    for batch in batches:
        grads = grad_fn(params, batch)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    cfg, model = _port_model()
    optimizer = ttrain.make_optimizer(model, lr)
    for s, batch in enumerate(batches):
        ttrain.train_step(model, optimizer, ttrain.to_batch(*batch,
                                                            device="cpu"),
                          tau=0.05, lr=ttrain.cosine_lr(lr, steps, s))
    got, want = _jax_tree(model, cfg), _tree_np(params)
    for group in ("embeddings", "layers"):
        for name, w in want[group].items():
            np.testing.assert_allclose(got[group][name], w, atol=2e-4,
                                       err_msg=f"{group}.{name}")


def test_train_draws_the_jax_batches_and_loss_curve(monkeypatch):
    """The whole ``train`` at its default bf16 compute: same batches in the
    same order, loss curve within 2e-2 relative of the JAX trainer's."""
    seen = {"jax": [], "port": []}

    def recorder(mod, key):
        pad = mod._pad

        def record(ids_list, seq):
            out = pad(ids_list, seq)
            seen[key].append(out)
            return out
        monkeypatch.setattr(mod, "_pad", record)

    recorder(jtrain, "jax")
    recorder(ttrain, "port")
    logged = []
    jtrain.train(CORPUS, config=jbert.BertConfig(**TINY),
                 **dict(TRAIN, log_every=1), steps=20, log=logged.append)
    jax_losses = [float(re.search(r"loss ([\d.]+)", s).group(1))
                  for s in logged]
    port_losses = []
    ttrain.train(CORPUS, config=tbert.BertConfig(**TINY), **TRAIN, steps=20,
                 device="cpu", losses=port_losses)
    assert len(seen["port"]) == len(seen["jax"]) == 40
    for got, want in zip(seen["port"], seen["jax"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(port_losses) == len(jax_losses) == 20
    # the JAX log rounds to 4 decimals
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-2, atol=1e-4)


@pytest.fixture(scope="module")
def trained():
    losses = []
    cfg, model, tok = ttrain.train(
        CORPUS, config=tbert.BertConfig(**TINY), **TRAIN, steps=60,
        device="cpu", losses=losses)
    return cfg, model, tok, losses


def _embed(model, tok, texts):
    ids = [tok.encode(t, max_length=32) for t in texts]
    a, m = jtrain._pad(ids, max(len(i) for i in ids))
    return tbert.encode(model, *ttrain.to_batch(a, m, a, m,
                                                device="cpu")[:2]).numpy()


def test_training_learns_retrieval(trained):
    """tests/unit/test_train_encoder.py's check on the port's weights."""
    cfg, model, tok, losses = trained
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    d = _embed(model, tok, CORPUS[:8])
    q = _embed(model, tok, [
        "slurm sbatch array", "gpu quota", "xrdcp transfer", "eos fuse mount",
        "kubernetes eviction", "grafana postgres", "jira permissions",
        "dagman rescue"])
    top1 = np.argmax(q @ d.T, axis=1)
    assert (top1 == np.arange(8)).mean() >= 0.75, top1


# ------------------------------------------------------------------ export
def test_state_dict_round_trips_exactly(trained):
    cfg, model = trained[:2]
    sd = ttrain.state_dict_from_params(model, cfg)
    assert "encoder.layer.1.output.dense.weight" in sd
    back = thf.params_from_state_dict(sd, cfg)
    state = model.state_dict()
    assert set(back) == set(state)
    for name, v in state.items():
        assert torch.equal(back[name], v), name
    np.testing.assert_array_equal(
        ttrain.state_dict_from_params(back, cfg)["embeddings.word_embeddings"
                                                 ".weight"],
        sd["embeddings.word_embeddings.weight"])


@pytest.mark.parametrize("pooling", ["mean", "attn"])
def test_snapshots_are_the_jax_package_bytes(tmp_path, pooling):
    """Same parameters → the same config.json, model.safetensors and
    vocab.txt, byte for byte."""
    jcfg = jbert.BertConfig(**dict(TINY, pooling=pooling))
    tcfg = tbert.BertConfig(**dict(TINY, pooling=pooling))
    params = jbert.init_params(jcfg, seed=2)
    tok = JaxTokenizer.build_vocab(CORPUS, size=TINY["vocab_size"])
    jtrain.save_model_dir(str(tmp_path / "jax"), jcfg, params, tok)
    state = thf.params_from_jax(_tree_np(params))
    ttrain.save_model_dir(str(tmp_path / "port"), tcfg, state, tok)
    for f in ("config.json", "model.safetensors", "vocab.txt"):
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f


def test_jax_snapshot_loads_in_the_port(tmp_path):
    jcfg = jbert.BertConfig(**TINY)
    _c, params, tok = jtrain.train(CORPUS, config=jcfg, **TRAIN, steps=3)
    jtrain.save_model_dir(str(tmp_path), jcfg, params, tok)
    cfg, state, vocab = thf.load_model_dir(str(tmp_path))
    assert cfg == tbert.BertConfig(**TINY) and os.path.exists(vocab)
    jemb = JaxEmbedder(model_dir=str(tmp_path), compute_dtype=jnp.float32,
                       max_length=32, attention_impl="xla")
    temb = TorchEmbedder(model_dir=str(tmp_path), device="cpu", max_length=32)
    np.testing.assert_allclose(temb.encode_numpy(CORPUS[:8]),
                               jemb.encode_numpy(CORPUS[:8]), atol=1e-5)


def test_port_snapshot_loads_in_the_jax_embedder(trained, tmp_path):
    cfg, model, tok = trained[:3]
    ttrain.save_model_dir(str(tmp_path), cfg, model, tok)
    assert {"config.json", "model.safetensors", "vocab.txt"} <= \
        set(os.listdir(tmp_path))
    jemb = JaxEmbedder(model_dir=str(tmp_path), compute_dtype=jnp.float32,
                       max_length=32, attention_impl="xla")
    temb = TorchEmbedder(model_dir=str(tmp_path), device="cpu", max_length=32)
    texts = CORPUS[:8] + ["slurm sbatch array", "gpu quota increase"]
    got = temb.encode_numpy(texts)
    np.testing.assert_allclose(got, jemb.encode_numpy(texts), atol=1e-5)
    # the loaded weights embed as the trained module does at f32
    model.compute_dtype = torch.float32
    try:
        np.testing.assert_allclose(got, _embed(model, tok, texts), atol=1e-5)
    finally:
        model.compute_dtype = torch.bfloat16


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(CORPUS, config=tbert.BertConfig(**TINY), **TRAIN,
                     steps=1)


def test_serving_and_training_models_hold_their_dtypes():
    cfg = tbert.BertConfig(**TINY)
    state = thf.params_from_jax(_tree_np(jbert.init_params(
        jbert.BertConfig(**TINY))))
    serve = tbert.BertEncoder.from_state(cfg, state, device="cpu",
                                         compute_dtype=torch.bfloat16)
    assert serve.layers[0].qkv.weight.dtype == torch.bfloat16
    assert serve.word.weight.dtype == torch.float32
    assert not any(p.requires_grad for p in serve.parameters())
    trainable = tbert.BertEncoder.for_training(
        cfg, state, device="cpu", compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable.parameters())
    ids, mask = ttrain.to_batch(*_batch()[:2], *_batch()[:2],
                                device="cpu")[:2]
    # both run the forward pass in bf16 from the same weights
    np.testing.assert_allclose(tbert.encode(serve, ids, mask).numpy(),
                               tbert.encode(trainable, ids, mask).numpy(),
                               atol=1e-6)


# ------------------------------------------------- the attention Function
def _qkv(dtype, b=2, s=6, nh=2, hd=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * nh * hd, generator=g, dtype=torch.float64)
    qkv = qkv.to(dtype).requires_grad_(True)
    h = nh * hd
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd)
               for i in range(3))
    key_bias = torch.zeros(b, s, dtype=torch.float32)
    key_bias[1, 4:] = -1e9
    return qkv, q, k, v, key_bias


def test_attention_function_gradcheck_f64():
    _qkv_t, q, k, v, key_bias = _qkv(torch.float64)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: differentiable_attention(q, k, v, key_bias.double(),
                                                 sm_scale=0.5), (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_gradient_is_the_plain_versions(dtype):
    qkv, q, k, v, key_bias = _qkv(dtype)
    out = differentiable_attention(q, k, v, key_bias, sm_scale=0.5)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (got,) = torch.autograd.grad(out, qkv, grad.to(dtype))
    qkv2, q2, k2, v2, _kb = _qkv(dtype)
    ref = plain_attention(q2, k2, v2, key_bias, sm_scale=0.5)
    (want,) = torch.autograd.grad(ref, qkv2, grad.to(dtype))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():
        assert not differentiable_attention(q, k, v, key_bias,
                                            sm_scale=0.5).requires_grad
