"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper, for the sm_90a build) and
skips without one.  The file imports no JAX, so it also runs where JAX is
not installed; ``tests/conftest.py`` imports JAX, so on such a machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from archi_tpu_torch.ops import LAUNCHES
from archi_tpu_torch.ops.attention import encoder_attention, plain_attention
from archi_tpu_torch.ops.topk import NEG_INF, fused_topk, plain_topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_topk_matches(vals, idx, ref_vals, scores, atol):
    """Tie-aware: scores within atol of the plain version's, and every
    returned row (distinct) really scores what the kernel reports."""
    vals, idx, ref_vals = (t.cpu().numpy() for t in (vals, idx, ref_vals))
    np.testing.assert_allclose(vals, ref_vals, rtol=0, atol=atol)
    live = vals > -1e29
    got = np.take_along_axis(scores.cpu().numpy(), idx.astype(np.int64), 1)
    np.testing.assert_allclose(got[live], vals[live], rtol=0, atol=atol)
    for row in idx:
        assert len(set(row.tolist())) == len(row)


def _case(dev, b, d, n_pad, n_active, dtype, per_query, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, d, generator=g), dim=1)
    e = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g), dim=1)
    if dtype == torch.int8:
        e = torch.clamp(torch.round(e * 127), -127, 127).to(torch.int8)
    else:
        e = e.to(dtype)
    alive = torch.rand(n_pad, generator=g) > 0.1
    bias = torch.where(alive, 0.0, NEG_INF)
    if per_query:
        bias = bias[None, :] + 0.3 * torch.rand(b, n_pad, generator=g)
    return q.to(dev), e.to(dev), bias.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,d,n_pad,n_active,k,per_query", [
    (1, 384, 4096, 4096, 10, False),
    (5, 384, 5000, 4321, 10, True),        # ragged edge, n_active < n_pad
    (32, 384, 20000, 20000, 128, False),
    (40, 96, 3000, 2999, 1, True),         # two query blocks, D % 32 == 0
    (3, 50, 1030, 700, 17, False),         # D not a multiple of 32
    (33, 384, 16384, 5000, 10, True),      # capacity far above the live rows
])
def test_fused_topk_matches_plain(dev, dtype, b, d, n_pad, n_active, k,
                                  per_query):
    q, e, bias = _case(dev, b, d, n_pad, n_active, dtype, per_query)
    before = LAUNCHES["fused_topk"]
    vals, idx = fused_topk(q, e, bias, n_active, k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_topk"] == before + 1
    ref_vals, ref_idx = plain_topk(q, e, bias, n_active, k=k)
    if dtype == torch.int8:
        # integer products summed exactly: identical results, ties included
        assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)
        return
    from archi_tpu_torch.ops.topk import _scores
    col = torch.arange(n_pad, device=dev)
    scores = torch.where(col < n_active, _scores(q, e) + bias, NEG_INF)
    assert_topk_matches(vals, idx, ref_vals, scores, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,d,k,per_query", [
    (1, 384, 10, False), (7, 100, 128, True), (32, 384, 10, True),
    (33, 768, 1, False), (256, 32, 10, True), (256, 384, 128, False),
])
def test_fused_topk_tensor_core_route(dev, dtype, b, d, k, per_query):
    """bf16 and int8 corpora take the tensor-core kernel (ragged n_active,
    D not a multiple of the 128-byte stage, 8 or 32 queries a CTA):
    bf16 within 1e-4 of the plain version, tie-aware; int8 identical."""
    from archi_tpu_torch.ops import ROUTE_LAUNCHES
    from archi_tpu_torch.ops.topk import _scores

    n_pad, n_active = 30_000, 29_011
    q, e, bias = _case(dev, b, d, n_pad, n_active, dtype, per_query, seed=b + d)
    before = dict(ROUTE_LAUNCHES)
    vals, idx = fused_topk(q, e, bias, n_active, k=k)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["fused_topk:tensor_core"] == \
        before["fused_topk:tensor_core"] + 1
    assert ROUTE_LAUNCHES["fused_topk:cuda_core"] == before["fused_topk:cuda_core"]
    ref_vals, ref_idx = plain_topk(q, e, bias, n_active, k=k)
    if dtype == torch.int8:
        assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)
        return
    col = torch.arange(n_pad, device=dev)
    scores = torch.where(col < n_active, _scores(q, e) + bias, NEG_INF)
    assert_topk_matches(vals, idx, ref_vals, scores, atol=1e-4)


def test_fused_topk_tensor_core_wide_rows(dev):
    """D = 4096 bf16: 32 queries no longer fit in shared memory beside the
    ring, so the kernel takes blocks of 8."""
    from archi_tpu_torch.ops.topk import _scores

    q, e, bias = _case(dev, 40, 4096, 3000, 2900, torch.bfloat16, True, seed=4)
    vals, idx = fused_topk(q, e, bias, 2900, k=20)
    ref_vals, _ = plain_topk(q, e, bias, 2900, k=20)
    col = torch.arange(3000, device=dev)
    scores = torch.where(col < 2900, _scores(q, e) + bias, NEG_INF)
    assert_topk_matches(vals, idx, ref_vals, scores, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fused_topk_ties_across_tiles_and_splits(dev, dtype):
    """Rows duplicated across 128-row tiles and across splits score equal;
    the lower row ranks first, exactly as in the plain stable sort."""
    q, e, bias = _case(dev, 40, 384, 50_000, 50_000, dtype, False, seed=9)
    bias.zero_()
    src = torch.arange(0, 50_000, 97, device=dev)
    for shift in (1, 127, 128, 4099, 25_001):   # within a tile, next tile, far
        dst = (src + shift) % 50_000
        e[dst] = e[src]
    vals, idx = fused_topk(q, e, bias, 50_000, k=64)
    ref_vals, ref_idx = plain_topk(q, e, bias, 50_000, k=64)
    if dtype == torch.int8:
        assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)
    else:   # f32 sums in another order: distinct rows may swap on near-ties
        from archi_tpu_torch.ops.topk import _scores
        assert_topk_matches(vals, idx, ref_vals, _scores(q, e) + bias, atol=1e-4)
    v, i = vals.cpu(), idx.cpu()
    tied = v[:, 1:] == v[:, :-1]
    assert tied.sum() >= 10          # the duplicates reached the top-64
    assert bool((i[:, 1:][tied] > i[:, :-1][tied]).all())


def _random_case(seed):
    """A random shape: batch across both query-block sizes, any D, a
    ragged n_pad, n_active anywhere, k up to 128, either bias kind."""
    rng = np.random.default_rng(seed)
    dtype = [torch.float32, torch.bfloat16, torch.int8][seed % 3]
    b = int(rng.integers(1, 70))
    d = int(rng.choice([8, 33, 64, 96, 130, 384]))
    n_pad = int(rng.integers(128, 9000))
    n_active = int(rng.integers(0, n_pad + 1))
    k = int(rng.integers(1, min(128, n_pad) + 1))
    return dtype, b, d, n_pad, n_active, k, bool(rng.integers(0, 2))


@pytest.mark.parametrize("seed", range(24))
def test_fused_topk_random_shapes(dev, seed):
    dtype, b, d, n_pad, n_active, k, per_query = _random_case(seed)
    q, e, bias = _case(dev, b, d, n_pad, n_active, dtype, per_query, seed)
    vals, idx = fused_topk(q, e, bias, n_active, k=k)
    ref_vals, ref_idx = plain_topk(q, e, bias, n_active, k=k)
    if dtype == torch.int8:
        assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)
        return
    from archi_tpu_torch.ops.topk import _scores
    col = torch.arange(n_pad, device=dev)
    scores = torch.where(col < n_active, _scores(q, e) + bias, NEG_INF)
    assert_topk_matches(vals, idx, ref_vals, scores, atol=1e-5)
    dead = (vals <= -1e29).cpu().numpy()
    # rows past n_active fill the tail in ascending order, as in the plain sort
    np.testing.assert_array_equal(idx.cpu().numpy()[dead],
                                  ref_idx.cpu().numpy()[dead])


def test_fused_topk_unaligned_and_strided_inputs(dev):
    """A corpus view off 16-byte alignment takes the scalar loads; strided
    queries and bias are made contiguous by the wrapper."""
    q, e, bias = _case(dev, 6, 64, 2000, 1900, torch.float32, True)
    buf = torch.empty(e.numel() + 1, device=dev)
    e_off = buf[1:].view(e.shape)
    e_off.copy_(e)
    assert e_off.data_ptr() % 16 != 0
    q_strided = torch.stack([q, q], dim=2)[:, :, 0]
    vals, idx = fused_topk(q_strided, e_off, bias.t().contiguous().t(), 1900, k=9)
    ref_vals, ref_idx = plain_topk(q, e, bias, 1900, k=9)
    torch.testing.assert_close(vals, ref_vals, rtol=0, atol=1e-5)


def test_fused_topk_rows_past_n_active_fill_small_corpora(dev):
    """k above the live rows: the list fills with NEG_INF rows, lowest
    first, exactly as the stable plain sort orders them."""
    q, e, bias = _case(dev, 2, 64, 1024, 3, torch.float32, False)
    bias.zero_()
    vals, idx = fused_topk(q, e, bias, 3, k=8)
    ref_vals, ref_idx = plain_topk(q, e, bias, 3, k=8)
    assert torch.equal(idx[:, 3:], ref_idx[:, 3:])
    assert torch.all(vals[:, 3:] == NEG_INF)
    torch.testing.assert_close(vals[:, :3], ref_vals[:, :3], rtol=0, atol=1e-5)


def test_fused_topk_rows_past_n_active_outrank_lower_live_scores(dev):
    """Live rows scored below NEG_INF (two stacked NEG_INF biases) rank
    after the masked rows, as in the plain sort of the masked score row."""
    q, e, bias = _case(dev, 4, 64, 4096, 2000, torch.float32, True)
    bias[:, 6:] = 2 * NEG_INF
    vals, idx = fused_topk(q, e, bias, 2000, k=12)
    ref_vals, ref_idx = plain_topk(q, e, bias, 2000, k=12)
    assert torch.equal(idx[:, 6:], ref_idx[:, 6:])
    assert torch.equal(idx[:, 6:].cpu(), torch.arange(2000, 2006,
                                                      dtype=torch.int32)
                       .expand(4, 6))
    torch.testing.assert_close(vals, ref_vals, rtol=0, atol=1e-5)


def test_empty_batches_launch_nothing(dev):
    q, e, bias = _case(dev, 1, 64, 512, 512, torch.bfloat16, False)
    before = dict(LAUNCHES)
    vals, idx = fused_topk(q[:0], e, bias, 512, k=5)
    assert vals.shape == (0, 5) and idx.shape == (0, 5)
    x = torch.empty(0, 16, 2, 32, device=dev)
    assert encoder_attention(x, x, x, torch.empty(0, 16, device=dev),
                             sm_scale=0.2).shape == (0, 16, 2, 32)
    assert LAUNCHES == before


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0, 2e-5),
                                             (torch.bfloat16, 2 ** -7, 1e-3)])
@pytest.mark.parametrize("b,s,nh,hd", [(3, 64, 4, 32), (2, 128, 2, 64),
                                       (2, 512, 12, 32), (4, 200, 3, 16)])
def test_encoder_attention_matches_plain(dev, dtype, rtol, atol, b, s, nh, hd):
    g = torch.Generator(device="cpu").manual_seed(1)
    qkv = torch.randn(b, s, 3 * nh * hd, generator=g).to(dev, dtype)
    h = nh * hd
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd) for i in range(3))
    mask = torch.ones(b, s)
    mask[0, s // 3:] = 0      # padded row
    mask[-1, :] = 0           # fully masked row stays finite
    key_bias = ((1.0 - mask) * -1e9).to(dev)
    before = LAUNCHES["encoder_attention"]
    out = encoder_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert LAUNCHES["encoder_attention"] == before + 1
    ref = plain_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    assert out.dtype == dtype and out.is_contiguous()
    assert torch.isfinite(out.float()).all()
    # bf16: at most one rounding step of the output apart
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(12))
def test_encoder_attention_random_shapes(dev, seed):
    rng = np.random.default_rng(seed)
    b, s = int(rng.integers(1, 9)), int(rng.integers(1, 300))
    nh, hd = int(rng.integers(1, 5)), int(rng.choice([8, 16, 32, 64]))
    dtype = [torch.float32, torch.bfloat16][seed % 2]
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, s, 3, nh, hd, generator=g).to(dev, dtype)
    q, k, v = x.unbind(2)                    # views with row stride 3*nh*hd
    lens = torch.from_numpy(rng.integers(0, s + 1, b))
    key_bias = ((torch.arange(s)[None, :] >= lens[:, None]).float()
                * -1e9).to(dev)
    out = encoder_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    ref = plain_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    assert torch.isfinite(out.float()).all()
    rtol, atol = (0, 2e-5) if dtype == torch.float32 else (2 ** -7, 1e-3)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def assert_bf16_attention_close(out, q, k, v, key_bias, sm_scale):
    """Within one bf16 step of the plain version's output (2^-7 |ref| +
    1e-3, as for the CUDA-core kernel) plus one bf16 step of each rounded
    probability (``p_rounding_bound``): the logits are summed in another
    order, so a p next to a rounding boundary may round the other way."""
    from archi_tpu_torch.ops.attention import p_rounding_bound

    ref = plain_attention(q, k, v, key_bias, sm_scale=sm_scale).float()
    tol = (ref.abs() * 2.0 ** -7 + 1e-3
           + p_rounding_bound(q, k, v, key_bias, sm_scale=sm_scale))
    excess = (out.float() - ref).abs() - tol
    assert float(excess.max()) <= 0, float(excess.max())


def _attention_inputs(dev, b, s, nh, hd, seed):
    """bf16 q, k, v as strided views of one [B, S, 3H] projection; key bias
    with ragged lengths, row 0 fully masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = nh * hd
    qkv = torch.randn(b, s, 3 * h, generator=g).to(dev, torch.bfloat16)
    q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd) for i in range(3))
    lens = torch.randint(1, s + 1, (b,), generator=g)
    lens[0] = 0
    key_bias = ((torch.arange(s)[None, :] >= lens[:, None]).float()
                * -1e9).to(dev)
    return q, k, v, key_bias


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("s", [1, 17, 64, 128, 200, 512])
def test_attention_tensor_core_route(dev, s, hd):
    """bf16 takes the tensor-core kernel: within one bf16 step of the plain
    version, which rounds p to bf16 as the kernel does."""
    from archi_tpu_torch.ops import ROUTE_LAUNCHES

    q, k, v, key_bias = _attention_inputs(dev, 3, s, 2, hd, seed=s + hd)
    before = dict(ROUTE_LAUNCHES)
    out = encoder_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["encoder_attention:tensor_core"] == \
        before["encoder_attention:tensor_core"] + 1
    assert ROUTE_LAUNCHES["encoder_attention:cuda_core"] == \
        before["encoder_attention:cuda_core"]
    assert torch.isfinite(out.float()).all()
    assert_bf16_attention_close(out, q, k, v, key_bias, hd ** -0.5)


@pytest.mark.parametrize("b,s,hd", [(256, 128, 32), (256, 64, 32),
                                    (64, 512, 64), (200, 17, 8)])
def test_attention_tensor_core_large_batches(dev, b, s, hd):
    q, k, v, key_bias = _attention_inputs(dev, b, s, 12, hd, seed=b + s)
    out = encoder_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    assert_bf16_attention_close(out, q, k, v, key_bias, hd ** -0.5)


def test_attention_tensor_core_unaligned_views(dev):
    """Views off 16-byte alignment take the element-wise copies into shared
    memory and give the same result as aligned copies."""
    q, k, v, key_bias = _attention_inputs(dev, 4, 100, 3, 16, seed=5)
    buf = torch.empty(q.numel() * 3 + 1, dtype=torch.bfloat16, device=dev)
    qkv = buf[1:].view(4, 100, 3 * 48)
    qkv.copy_(torch.cat([q.reshape(4, 100, 48), k.reshape(4, 100, 48),
                         v.reshape(4, 100, 48)], dim=2))
    views = [qkv[..., i * 48:(i + 1) * 48].view(4, 100, 3, 16) for i in range(3)]
    assert views[0].data_ptr() % 16 != 0
    out = encoder_attention(*views, key_bias, sm_scale=0.25)
    want = encoder_attention(q, k, v, key_bias, sm_scale=0.25)
    assert torch.equal(out, want)


def test_bf16_main_path_takes_the_tensor_core_routes(dev):
    """A bf16 encoder call and a bf16 flat-index search launch only the
    tensor-core kernels."""
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.models.bert import BertConfig, BertEncoder, encode, init_params
    from archi_tpu_torch.models.hf_loader import params_from_jax
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches

    cfg = BertConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128, max_position_embeddings=128)
    model = BertEncoder.from_state(cfg, params_from_jax(init_params(cfg, seed=3)),
                                   device=dev, compute_dtype=torch.bfloat16)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (4, 64)))
    index = FlatIndex(64, dtype=torch.bfloat16, device=dev)
    index.add(torch.randn(5000, 64), list(range(5000)))
    reset_launches()
    emb = encode(model, ids.to(dev), torch.ones(4, 64, dtype=torch.long, device=dev))
    index.search_dispatch(emb.float(), k=5)
    torch.cuda.synchronize()
    assert {k: v for k, v in ROUTE_LAUNCHES.items() if v} == {
        "fused_topk:tensor_core": 1, "encoder_attention:tensor_core": 2}


def test_encoder_on_card_matches_cpu(dev):
    """The whole encoder in f32 on the card (kernel attention) against the
    same weights on the CPU (plain attention)."""
    from archi_tpu_torch.models.bert import BertConfig, BertEncoder, encode, init_params
    from archi_tpu_torch.models.hf_loader import params_from_jax

    cfg = BertConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128, max_position_embeddings=128)
    state = params_from_jax(init_params(cfg, seed=3))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (4, 64)))
    mask = torch.ones(4, 64, dtype=torch.long)
    mask[1, 20:] = 0
    outs = []
    for device in ("cpu", dev):
        model = BertEncoder.from_state(cfg, state, device=device)
        outs.append(encode(model, ids.to(device), mask.to(device)).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ ADC
def _adc_case(dev, m, g, s, ksub, seed):
    rng = np.random.default_rng(seed)
    luts = torch.from_numpy(rng.standard_normal((m, g, ksub)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, ksub, (m, s)).astype(np.uint8))
    return luts.to(dev), codes.to(dev)


@pytest.mark.parametrize("m,g,s", [(8, 1, 1), (16, 3, 1000), (48, 1, 262_145),
                                   (48, 4, 131_072), (96, 2, 5003),
                                   (48, 256, 4097), (96, 256, 999)])
def test_adc_scores_matches_plain(dev, m, g, s):
    """The kernel sums the bf16-rounded table in subspace order, as the plain
    version does: identical f32 scores.  G = 256 tiles the queries and (at
    m = 96) splits the table into runs of subspaces."""
    from archi_tpu_torch.ops.adc import adc_scores, plain_adc_scores

    luts, codes = _adc_case(dev, m, g, s, 256, seed=m + g + s)
    before = LAUNCHES["adc_scores"]
    out = adc_scores(luts, codes)
    torch.cuda.synchronize()
    assert LAUNCHES["adc_scores"] == before + 1
    assert out.shape == (g, s) and out.dtype == torch.float32
    torch.testing.assert_close(out, plain_adc_scores(luts, codes), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("m,g,s", [(8, 1, 1), (16, 2, 131_072), (48, 2, 131_071),
                                   (48, 9, 777), (96, 256, 2049)])
def test_adc_scores_lut16_matches_plain(dev, m, g, s):
    from archi_tpu_torch.ops.adc import (adc_scores_lut16, pack_nibbles,
                                         plain_adc_scores_lut16)

    luts, codes = _adc_case(dev, m, g, s, 16, seed=m * g + s)
    packed_t = pack_nibbles(codes.t()).t().contiguous()
    before = LAUNCHES["adc_scores_lut16"]
    out = adc_scores_lut16(luts, packed_t)
    torch.cuda.synchronize()
    assert LAUNCHES["adc_scores_lut16"] == before + 1
    torch.testing.assert_close(out, plain_adc_scores_lut16(luts, packed_t),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(16))
def test_adc_random_shapes(dev, seed):
    """Random (m, G, S): G up to 256 for the query tiling, odd S, m in
    {8, 16, 48, 96}, both code widths, ksub below 256 for 8-bit codes."""
    from archi_tpu_torch.ops.adc import (adc_scores, adc_scores_lut16,
                                         pack_nibbles, plain_adc_scores,
                                         plain_adc_scores_lut16)

    rng = np.random.default_rng(100 + seed)
    m = int(rng.choice([8, 16, 48, 96]))
    g = int(rng.integers(1, 257))
    s = int(rng.integers(1, 40_000)) | 1
    if seed % 2:
        luts, codes = _adc_case(dev, m, g, s, 16, seed)
        packed_t = pack_nibbles(codes.t()).t().contiguous()
        got, want = (adc_scores_lut16(luts, packed_t),
                     plain_adc_scores_lut16(luts, packed_t))
    else:
        ksub = int(rng.choice([16, 100, 256]))
        luts, codes = _adc_case(dev, m, g, s, ksub, seed)
        got, want = adc_scores(luts, codes), plain_adc_scores(luts, codes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_adc_strided_inputs_and_empty_shapes(dev):
    from archi_tpu_torch.ops.adc import adc_scores, plain_adc_scores

    luts, codes = _adc_case(dev, 16, 3, 5000, 256, seed=7)
    wide = torch.stack([codes, codes], dim=2)[:, :, 0]   # strided view
    assert not wide.is_contiguous()
    torch.testing.assert_close(adc_scores(luts.transpose(0, 1).contiguous()
                                          .transpose(0, 1), wide),
                               plain_adc_scores(luts, codes), rtol=0, atol=1e-5)
    before = dict(LAUNCHES)
    assert adc_scores(luts, codes[:, :0]).shape == (3, 0)
    assert adc_scores(luts[:, :0], codes).shape == (0, 5000)
    assert LAUNCHES == before


def _adc_launch(dev, m, g, s, ksub, packed, seed, offset=0):
    """One ADC kernel launch against its plain version on a random input
    (ksub 16 for packed codes); checks the launch counter and returns the
    route the launch took.  offset: bytes between a 16-byte aligned buffer
    and the codes."""
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, adc

    luts, codes = _adc_case(dev, m, g, s, 16 if packed else ksub, seed)
    if packed:
        codes = adc.pack_nibbles(codes.t()).t().contiguous()
    if offset:
        buf = torch.empty(codes.numel() + offset, dtype=torch.uint8, device=dev)
        codes = buf[offset:].view(codes.shape).copy_(codes)
        assert codes.is_contiguous() and codes.data_ptr() % 16 == offset
    name = "adc_scores_lut16" if packed else "adc_scores"
    kernel, plain = ((adc.adc_scores_lut16, adc.plain_adc_scores_lut16) if packed
                     else (adc.adc_scores, adc.plain_adc_scores))
    before, routes = LAUNCHES[name], dict(ROUTE_LAUNCHES)
    out = kernel(luts, codes)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    rose = {k: ROUTE_LAUNCHES[k] - routes[k] for k in ROUTE_LAUNCHES
            if ROUTE_LAUNCHES[k] != routes[k]}
    assert len(rose) == 1 and list(rose.values()) == [1], rose
    (key,) = rose
    assert key.split(":")[0] == name
    assert out.shape == (g, s) and out.dtype == torch.float32
    assert float((out - plain(luts, codes)).abs().max()) <= 1e-5
    return key.split(":")[1]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 9, 256])
def test_adc_every_query_tile(dev, g, packed):
    """G = 1, 2, 4, 8 fill a query tile; 3 and 5 pad one; 9 and 256 tile
    G over blockIdx.y."""
    assert _adc_launch(dev, 48, g, 8192, 256, packed, seed=g) == "vector"


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s", [1 << 20, (1 << 19) + 8])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_adc_eight_column_loads(dev, g, s, packed):
    """Rows long enough for 8-byte loads at query tiles 1, 2 and 4, as
    ``adc_topk``'s 2^20-column tiles give them at a batch of 4 or fewer;
    at 2^19 + 8 columns the last warp tile has one lane."""
    from archi_tpu_torch.ops import adc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert adc.columns_per_lane(s, g, 0, sms) == 8
    assert _adc_launch(dev, 48, g, s, 256, packed, seed=g + s) == "vector"


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s,want", [(1, "byte"), (15, "byte"), (16, "vector"),
                                    (17, "byte"), ((1 << 17) + 3, "byte"),
                                    ((1 << 17) + 4, "vector")])
def test_adc_row_lengths(dev, s, want, packed):
    """A row length the 4-byte loads do not divide takes the byte route."""
    assert _adc_launch(dev, 16, 2, s, 256, packed, seed=s) == want


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_adc_unaligned_codes(dev, offset, packed):
    """Codes at an odd address take the byte route; an address aligned to 4
    or 8 bytes takes the loads it allows."""
    want = "byte" if offset % 4 else "vector"
    assert _adc_launch(dev, 48, 2, 4096, 256, packed, seed=offset,
                       offset=offset) == want


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("ksub", [10, 16, 100, 256])
def test_adc_scores_code_widths(dev, ksub, g):
    """8-bit codes with tables of fewer than 256 entries (10: a table row
    that is not whole float4s)."""
    assert _adc_launch(dev, 48, g, 20_000, ksub, False, seed=ksub + g) == "vector"


@pytest.mark.parametrize("m,g,packed", [(96, 256, False), (200, 8, False),
                                        (96, 256, True), (512, 8, True)])
def test_adc_subspace_runs(dev, m, g, packed):
    """Tables above the shared-memory budget (8-bit m = 96 and 200 at query
    tile 8) split into runs of subspaces that keep the sum's order; the
    4-bit ones fit up to m = 512 in one run."""
    assert _adc_launch(dev, m, g, 4100, 256, packed, seed=m + g) == "vector"


@pytest.mark.parametrize("m,g,s,packed", [(48, 1, 64 * 11 * 512, False),
                                          (48, 2, 1 << 17, True)])
def test_adc_ann_path_shapes(dev, m, g, s, packed):
    """Path A's 8-bit ADC (one query a group over 64 cells of up to 11
    blocks of 512) and path B's 4-bit ADC (groups of 2 over 2 x 128 blocks)
    at their exact shapes, on the vectorised route."""
    assert _adc_launch(dev, m, g, s, 256, packed, seed=s) == "vector"
