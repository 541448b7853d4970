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


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_function_runs_the_kernel_forward_and_plain_gradient(
        dev, dtype):
    """``differentiable_attention`` under autograd: the forward is the
    kernel (one launch on the dtype's route, within the forward tests'
    tolerance of the plain version), the gradient is the plain version's
    autograd gradient."""
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches
    from archi_tpu_torch.ops.attention import (differentiable_attention,
                                               p_rounding_bound)

    b, s, nh, hd = 8, 96, 12, 32
    h = nh * hd
    g = torch.Generator(device="cpu").manual_seed(5)
    base = torch.randn(b, s, 3 * h, generator=g)
    grad_out = torch.randn(b, s, nh, hd, generator=g).to(dev, dtype)
    mask = torch.ones(b, s)
    mask[1, 40:] = 0
    mask[5, 7:] = 0
    key_bias = ((1.0 - mask) * -1e9).to(dev)

    def views():
        qkv = base.to(dev, dtype).requires_grad_(True)
        return qkv, [qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd)
                     for i in range(3)]

    qkv, (q, k, v) = views()
    reset_launches()
    out = differentiable_attention(q, k, v, key_bias, sm_scale=hd ** -0.5)
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert ROUTE_LAUNCHES[f"encoder_attention:{route}"] == 1
    (got,) = torch.autograd.grad(out, qkv, grad_out)
    qkv2, (q2, k2, v2) = views()
    ref = plain_attention(q2, k2, v2, key_bias, sm_scale=hd ** -0.5)
    (want,) = torch.autograd.grad(ref, qkv2, grad_out)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        bound = p_rounding_bound(q2.detach(), k2.detach(), v2.detach(),
                                 key_bias, sm_scale=hd ** -0.5)
        assert bool((diff <= ref.float().abs() * 2.0 ** -7 + 1e-3
                     + bound).all())
    else:
        assert float(diff.max()) <= 2e-5
    torch.testing.assert_close(got, want)


def test_training_step_on_card_matches_cpu_at_f32(dev):
    """One ``train_step`` at f32 from the same weights and batch: the loss
    within 1e-4 relative of the CPU's, each gradient within 1e-4 of the
    CPU's largest entry of that tensor."""
    from archi_tpu_torch.models import train_encoder as te
    from archi_tpu_torch.models.bert import BertConfig, BertEncoder, init_params
    from archi_tpu_torch.models.hf_loader import params_from_jax

    cfg = BertConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128, max_position_embeddings=128)
    state = params_from_jax(init_params(cfg, seed=3))
    rng = np.random.default_rng(0)
    lists = [[2, *rng.integers(5, 300, int(n)), 3]
             for n in rng.integers(3, 60, 16)]
    batch = (*te._pad(lists[:8], 64), *te._pad(lists[8:], 64))
    outs = {}
    for device in ("cpu", dev):
        model = BertEncoder.for_training(cfg, state, device=device)
        opt = te.make_optimizer(model, 3e-4)
        loss = te.train_step(model, opt, te.to_batch(*batch, device=device),
                             tau=0.05, lr=3e-4)
        outs[str(device)] = (loss.item(), {n: p.grad.cpu() for n, p in
                                           model.named_parameters()})
    (l_cpu, g_cpu), (l_dev, g_dev) = outs["cpu"], outs["cuda"]
    assert abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu)
    for name, want in g_cpu.items():
        err = float((g_dev[name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), name


def test_native_analyzer_builds_on_the_card_machine(dev):
    """The card's machine builds and loads the native text analyzer, and
    its routes agree."""
    from archi_tpu_torch import native
    from archi_tpu_torch.engine.bm25 import STOPWORDS, analyze
    from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

    assert native.load_library() is not None
    text = "Running the GPU partitions: quotas of 100GB, café naïve!"
    assert analyze(text) == analyze(text, stopwords=set(STOPWORDS)) == [
        "running", "gpu", "partitions", "quotas", "100gb", "cafe", "naive"]
    tok = WordPieceTokenizer.build_vocab([text], size=200)
    python = WordPieceTokenizer(dict(tok.vocab))
    python._native = None
    assert tok._native_encoder() is not None
    assert tok.encode(text, 16) == python.encode(text, 16)


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


# ------------------------------------------------------ the multi-device tier
def _same_topk(got, want, tol):
    """(vals, rows) tie-aware: scores within tol position by position; a
    live row in one list only ties with the last live score kept."""
    (gv, gr), (wv, wr) = got, want
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    for b in range(gv.shape[0]):
        g = {int(r): v for r, v in zip(gr[b], gv[b]) if v > -1e29}
        w = {int(r): v for r, v in zip(wr[b], wv[b]) if v > -1e29}
        live = wv[b][wv[b] > -1e29]
        for r in set(g) ^ set(w):
            assert abs(g.get(r, w.get(r)) - live[-1]) <= tol, (b, r)


def _unit_rows(n, d, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1)


@pytest.mark.parametrize("tile,blocks", [
    (256, (1000, 4000)),                 # growth 1024 -> 8192, rows move
    (128, (777, 1024, 1200, 5)),         # ragged blocks across seams
])
def test_sharded_flat_matches_flat_on_one_card(dev, tile, blocks):
    """Four shards on cuda:0 against one FlatIndex, bf16: the same scores
    (1e-6) and rows (tie-aware) through growth, tombstones, a short filter
    and a per-query bias; every top-k launch on the tensor cores."""
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches

    d = 384
    sharded = ShardedFlatIndex(d, devices=["cuda:0"] * 4, tile_n=tile)
    flat = FlatIndex(d, tile_n=tile, device="cuda")
    x = _unit_rows(sum(blocks), d, 1)
    s0 = 0
    for n in blocks:
        ids = [f"r{i}" for i in range(s0, s0 + n)]
        assert sharded.add(x[s0:s0 + n].to(dev), ids) == \
            flat.add(x[s0:s0 + n].to(dev), ids)
        s0 += n
    assert sharded.shard_cap * 4 == sharded.capacity
    assert all(e.device == torch.device("cuda", 0) for e in sharded._embs)
    dead = [f"r{i}" for i in range(0, s0, 97)]
    sharded.delete(dead), flat.delete(dead)
    q = torch.cat([x[[3, s0 - 1]], _unit_rows(30, d, 2)]).to(dev)
    n_rows = sharded.n_rows
    rng = np.random.default_rng(0)
    bias = torch.from_numpy(0.2 * rng.random((32, n_rows - 50)).astype(
        np.float32)).to(dev)
    fm = torch.from_numpy((rng.random(n_rows // 2) > 0.3).astype(
        np.float32)).to(dev)
    reset_launches()
    for kw in ({}, {"bias": bias}, {"filter_mask": fm, "bias": bias[0]}):
        for k in (1, 10, 128):
            _gi, gv, gr = sharded.search(q, k=k, **kw)
            _wi, wv, wr = flat.search(q, k=k, **kw)
            _same_topk((gv, gr), (wv, wr), 1e-6)
    assert ROUTE_LAUNCHES["fused_topk:cuda_core"] == 0
    assert ROUTE_LAUNCHES["fused_topk:tensor_core"] == 9 * (4 + 1)


def _plain_adc(ivfs):
    """Make each IVF-PQ index score with the plain ADC (on the card)."""
    import functools

    for ivf in ivfs:
        ivf.search_dispatch = functools.partial(ivf.search_dispatch,
                                                adc_impl="plain")


def test_sharded_ivfpq_on_one_card_matches_plain_adc(dev):
    """Four IVF-PQ shards on cuda:0: the 8-bit ADC kernel on the vectorised
    route gives the results of the plain ADC on the same shards, with a
    global bias and the host rerank."""
    from archi_tpu_torch.engine.host_store import HostVectorStore
    from archi_tpu_torch.engine.sharded_ivfpq import ShardedIVFPQIndex
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches

    x = _unit_rows(8192, 64, 3).numpy()
    idx = ShardedIVFPQIndex.build(x, None, devices=["cuda:0"] * 4, nlist=16,
                                  block=128, m=8, refine_m=8)
    assert all(s.device == torch.device("cuda", 0) for s in idx.shards)
    q = x[[5, 2100, 4500, 8000]] + 0.01
    bias = np.zeros(8192, np.float32)
    bias[[5, 7000]] = [-1e30, 2.0]
    store = HostVectorStore(64)
    store.add(x)
    cases = ({"nprobe": 4}, {"nprobe": 16, "bias": bias},
             {"nprobe_blocks": 8, "rerank_store": store})
    reset_launches()
    got = [idx.search(q, k=10, **kw) for kw in cases]
    assert LAUNCHES["adc_scores"] > 0
    assert ROUTE_LAUNCHES["adc_scores:vector"] == LAUNCHES["adc_scores"]
    _plain_adc(idx.shards)
    for (_gi, gv, gr), kw in zip(got, cases):
        _i, wv, wr = idx.search(q, k=10, **kw)
        _same_topk((gv, gr), (wv, wr), 1e-5)


def test_sharded_xl_on_one_card_matches_plain_adc(dev):
    """Four XL shards on cuda:0 (snapshots and fresh tails): the 4-bit ADC
    kernel on the vectorised route and the top-k on the tensor cores give
    the results of the plain ADC on the same shards."""
    from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches

    d = 64
    x = _unit_rows(9000, d, 4).numpy()
    idx = ShardedXlPQIndex(d, devices=["cuda:0"] * 4, nlist=16, block=128,
                           pq_m=8, pq_refine_m=8, nprobe_blocks=16,
                           min_snapshot_rows=1024, build_block_rows=1024)
    for s0 in range(0, 9000, 1500):
        idx.add(x[s0:s0 + 1500], list(range(s0, s0 + 1500)))
    assert all(s._n_snap > 0 and s.n_rows > s._n_snap for s in idx.shards)
    idx.delete([7, 4000])
    q = x[[7, 100, 3000, 8999]] + 0.01
    bias = np.zeros((4, 9000), np.float32)
    bias[np.arange(4), [10, 2000, 5000, 8500]] = 3.0
    cases = ({}, {"bias": torch.from_numpy(bias).to(dev)},
             {"filter_mask": (np.arange(9000) % 3 > 0).astype(np.float32)})
    reset_launches()
    got = [idx.search(q, k=10, **kw) for kw in cases]
    assert LAUNCHES["adc_scores_lut16"] > 0 and LAUNCHES["fused_topk"] > 0
    assert ROUTE_LAUNCHES["adc_scores_lut16:vector"] == \
        LAUNCHES["adc_scores_lut16"]
    assert ROUTE_LAUNCHES["fused_topk:tensor_core"] == LAUNCHES["fused_topk"]
    _plain_adc(s._ivf for s in idx.shards)
    for (_gi, gv, gr), kw in zip(got, cases):
        _i, wv, wr = idx.search(q, k=10, **kw)
        _same_topk((gv, gr), (wv, wr), 1e-5)
    assert 7 not in set(got[0][2].reshape(-1).tolist())


def test_one_rank_nccl_group_merges_like_no_group(dev, monkeypatch):
    """A one-process NCCL group: the sharded search goes through
    ``all_gather`` and returns what it returns without a group, bit for
    bit."""
    import socket

    import torch.distributed as dist

    from archi_tpu_torch.engine import distributed
    from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex

    idx = ShardedFlatIndex(384, devices=["cuda:0"] * 4, tile_n=256)
    idx.add(_unit_rows(6000, 384, 5).to(dev), list(range(6000)))
    q = _unit_rows(8, 384, 6).to(dev)
    bias = torch.rand(8, 6000, device=dev) * 0.1
    want = [idx.search(q, k=k, bias=b) for k in (1, 10) for b in (None, bias)]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    gathered = []
    real = distributed.all_gather

    def counted(t, group):
        gathered.append(t.shape)
        return real(t, group)

    monkeypatch.setattr("archi_tpu_torch.engine.sharded_index.all_gather",
                        counted)
    distributed.initialize_distributed()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        got = [idx.search(q, k=k, bias=b) for k in (1, 10)
               for b in (None, bias)]
    finally:
        dist.destroy_process_group()
    assert len(gathered) == 8
    for (gi, gv, gr), (wi, wv, wr) in zip(got, want):
        assert gi == wi and (gr == wr).all()
        assert np.array_equal(gv, wv)


def test_data_parallel_encode_matches_one_device(dev):
    """``TorchEmbedder(devices=["cuda:0"] * 2)``: each batch split in two
    on the card; the same embeddings as one device (cosine >= 0.9999, bf16),
    every attention launch on the tensor cores."""
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.ops import ROUTE_LAUNCHES, reset_launches

    cfg = BertConfig(vocab_size=512, hidden_size=384, num_layers=2,
                     num_heads=12, intermediate_size=1536,
                     max_position_embeddings=512)
    one = TorchEmbedder(config=cfg, device="cuda")
    two = TorchEmbedder(config=cfg, devices=["cuda:0"] * 2,
                        tokenizer=one.tokenizer)
    texts = [f"document {i} " + "words about storage " * (i % 40)
             for i in range(300)]
    reset_launches()
    a = two.encode_numpy(texts)
    assert ROUTE_LAUNCHES["encoder_attention:tensor_core"] == \
        LAUNCHES["encoder_attention"] > 0
    b = one.encode_numpy(texts)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) *
                            np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.9999, cos.min()


def test_evaluate_fixture_on_the_card_matches_the_cpu(dev, tmp_path):
    """``archi-tpu-torch evaluate --fixture`` through the top-k kernel
    gives the CPU run's totals (the plain version), but for the clocks."""
    from archi_tpu_torch.cli.evaluate import run_evaluate

    before = LAUNCHES["fused_topk"]
    runs = [run_evaluate(fixture=True, device=d, out=str(tmp_path / d))
            for d in ("cuda", "cpu")]
    assert LAUNCHES["fused_topk"] > before
    got, want = ({k: v for k, v in r["totals"].items()
                  if k not in ("query_qps", "avg_time_elapsed")}
                 for r in runs)
    assert got == want and got["recall_at_k"] >= 0.99
    assert [q["sources_metadata"] for q in runs[0]["questions"].values()] \
        == [q["sources_metadata"] for q in runs[1]["questions"].values()]
