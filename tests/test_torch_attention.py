"""The port's attention (plain version, via the kernel wrapper on CPU
tensors) against the JAX package's Pallas kernel in interpret mode.

The JAX kernel takes [B, nh, hd, S]; the port takes [B, S, nh, hd], so the
same numpy inputs are transposed for each.  Tolerance: f32 rtol 2e-5, as in
tests/unit/test_encoder.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.ops.pallas_attention import encoder_attention as jax_attention
from archi_tpu_torch.ops.attention import encoder_attention, plain_attention


def _inputs(seed, b, s, nh, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2 + 3:] = 0.0     # a padded row
    mask[-1, :] = 0.0              # a fully masked row
    key_bias = ((1.0 - mask) * -1e9).astype(np.float32)
    return q, k, v, key_bias


def _jax(q, k, v, key_bias, sm_scale):
    t = lambda x: jnp.asarray(x.transpose(0, 2, 3, 1))  # noqa: E731
    out_t = jax_attention(t(q), t(k), t(v), jnp.asarray(key_bias),
                          sm_scale=sm_scale, interpret=True)
    return np.asarray(out_t).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", [64, 128])
def test_attention_matches_pallas_interpret(hd, s):
    b, nh = 3, 2
    q, k, v, key_bias = _inputs(hd + s, b, s, nh, hd)
    sm_scale = float(1.0 / np.sqrt(hd))
    want = _jax(q, k, v, key_bias, sm_scale)
    got = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v, key_bias)),
                            sm_scale=sm_scale)
    assert got.shape == (b, s, nh, hd) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("hd", [8, 32])
def test_attention_bf16_matches_pallas_interpret(hd):
    """bf16 inputs: both round the unnormalised probabilities to bf16 before
    the PV product and sum them in f32.  Tolerance: one bf16 step of the
    reference's output (2^-7 relative; 2^-10 absolute for outputs near 0,
    where the f32 sums in another order may round across a step)."""
    b, s, nh = 3, 64, 2
    q, k, v, key_bias = _inputs(7 + hd, b, s, nh, hd)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    sm_scale = float(1.0 / np.sqrt(hd))
    t = lambda x: jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1),  # noqa: E731
                              dtype=jnp.bfloat16)
    want = np.asarray(jax_attention(
        t(q), t(k), t(v), jnp.asarray(key_bias), sm_scale=sm_scale,
        interpret=True).astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = encoder_attention(q, k, v, torch.from_numpy(key_bias),
                            sm_scale=sm_scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, nh, hd)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -10)
    # the same rounding of p gives the same bf16 output almost everywhere
    # (all of it at these seeds); p kept in f32 matches only about 77%
    assert (got == want).mean() >= 0.99


def test_padding_keys_do_not_leak():
    """Values at padded key positions must not reach the real rows."""
    q, k, v, key_bias = _inputs(0, 3, 64, 2, 32)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    base = plain_attention(t(q), t(k), t(v), t(key_bias), sm_scale=0.2)
    v2 = v.copy()
    v2[0, 40:] = 1e3               # row 0 pads from 35 on
    moved = plain_attention(t(q), t(k), t(v2), t(key_bias), sm_scale=0.2)
    np.testing.assert_array_equal(moved.numpy()[0], base.numpy()[0])


def test_strided_views_of_fused_projection():
    """q, k, v as views of one [B, S, 3H] projection give the same result
    as contiguous copies."""
    b, s, nh, hd = 2, 64, 4, 16
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * nh * hd))
                           .astype(np.float32))
    h = nh * hd
    views = [qkv[..., i * h:(i + 1) * h].view(b, s, nh, hd) for i in range(3)]
    bias = torch.zeros(b, s)
    a = encoder_attention(*views, bias, sm_scale=0.25)
    c = encoder_attention(*(x.contiguous() for x in views), bias, sm_scale=0.25)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
