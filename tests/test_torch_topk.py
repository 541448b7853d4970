"""The port's top-k (plain version and dispatch) against the JAX package.

Same numpy inputs through ``archi_tpu.engine.topk.xla_topk``, the Pallas
kernel ``fused_topk`` in interpret mode, and the port's ``plain_topk`` /
``topk_scores``.  Tolerance rtol/atol 1e-4 as in tests/unit/test_topk.py;
row sets are compared tie-aware: every returned row must score what is
reported, so rows may differ only between equal scores.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from archi_tpu.engine import topk as jtopk
from archi_tpu.ops.pallas_topk import fused_topk as jax_fused_topk
from archi_tpu_torch.engine import topk as ttopk
from archi_tpu_torch.ops.topk import NEG_INF, fused_topk, plain_topk

TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _inputs(seed, b, d, n_pad, n_active, dtype, per_query, n_dead=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = np.zeros((n_pad, d), np.float32)
    e[:n_active] = rng.standard_normal((n_active, d))
    e[:n_active] /= np.linalg.norm(e[:n_active], axis=1, keepdims=True)
    alive = np.zeros(n_pad, np.float32)
    alive[:n_active] = 1.0
    alive[rng.choice(n_active, size=min(n_dead, n_active), replace=False)] = 0
    bias = np.where(alive > 0.5, 0.0, NEG_INF).astype(np.float32)
    if per_query:
        bias = (bias[None, :]
                + 0.3 * rng.random((b, n_pad))).astype(np.float32)
    if dtype == "int8":
        e = np.clip(np.round(e * 127.0), -127, 127).astype(np.int8)
    elif dtype == "bfloat16":
        e = e.astype(ml_dtypes.bfloat16)
    return q, e, bias


def _torch(q, e, bias, dtype):
    te = (torch.from_numpy(e.astype(np.float32)).to(torch.bfloat16)
          if dtype == "bfloat16" else torch.from_numpy(e))
    return torch.from_numpy(q), te, torch.from_numpy(bias)


def _exact_scores(q, e, bias, n_active, dtype):
    """f64 scores of the operands as both packages round them."""
    if dtype == "int8":
        q = np.clip(np.round(q * 127.0), -127, 127)
        s = (q.astype(np.float64) @ e.astype(np.float64).T) / (127.0 * 127.0)
    else:
        qr = q.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else q
        s = qr.astype(np.float64) @ e.astype(np.float64).T
    s = s + bias.astype(np.float64)
    s[:, n_active:] = NEG_INF
    return s


def assert_same_topk(got_vals, got_idx, want_vals, scores):
    got_vals, got_idx = np.asarray(got_vals), np.asarray(got_idx)
    np.testing.assert_allclose(got_vals, np.asarray(want_vals),
                               rtol=TOL, atol=TOL)
    live = got_vals > -1e29
    claimed = np.take_along_axis(scores, got_idx.astype(np.int64), axis=1)
    np.testing.assert_allclose(claimed[live], got_vals[live],
                               rtol=TOL, atol=TOL)
    for row in got_idx:
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_plain_topk_matches_xla_topk(dtype, per_query, k):
    b, d, n_pad, n_active = 4, 64, 1024, 1000
    q, e, bias = _inputs(k, b, d, n_pad, n_active, dtype, per_query)
    jv, ji = jtopk.xla_topk(jnp.asarray(q), jnp.asarray(e),
                            jnp.asarray(bias), n_active, k=k)
    tv, ti = plain_topk(*_torch(q, e, bias, dtype), n_active, k=k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tuple(tv.shape) == (b, k)
    scores = _exact_scores(q, e, bias, n_active, dtype)
    assert_same_topk(tv.numpy(), ti.numpy(), np.asarray(jv), scores)
    assert_same_topk(np.asarray(jv), np.asarray(ji), tv.numpy(), scores)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_query", [False, True])
def test_fused_topk_cpu_matches_pallas_interpret(dtype, per_query):
    """The port's kernel wrapper on CPU tensors (its plain version) against
    the Pallas kernel run in interpret mode, tombstones and n_active < N."""
    b, d, n_pad, n_active, k = 3, 32, 512, 430, 10
    q, e, bias = _inputs(5, b, d, n_pad, n_active, dtype, per_query, n_dead=40)
    jv, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(e), jnp.asarray(bias),
                            n_active, k=k, tile_n=256, interpret=True)
    tv, ti = fused_topk(*_torch(q, e, bias, dtype), n_active, k=k)
    scores = _exact_scores(q, e, bias, n_active, dtype)
    assert_same_topk(tv.numpy(), ti.numpy(), np.asarray(jv), scores)
    dead = bias[..., :n_active].reshape(-1, n_active).min(axis=0) < -1e29
    assert not np.isin(ti.numpy(), np.flatnonzero(dead)).any()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ties_prefer_the_lower_row(dtype):
    """Duplicated rows score equal: both packages rank the lower row first."""
    b, d, n_pad, k = 2, 16, 256, 12
    q, e, bias = _inputs(9, b, d, n_pad, n_pad, dtype, False, n_dead=0)
    e[100:110] = e[3]           # ten copies of row 3
    e[200:205] = e[7]
    q[0] = e[3].astype(np.float32) / (127.0 if dtype == "int8" else 1.0)
    jv, ji = jtopk.xla_topk(jnp.asarray(q), jnp.asarray(e), jnp.asarray(bias),
                            n_pad, k=k)
    tv, ti = plain_topk(*_torch(q, e, bias, dtype), n_pad, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    assert ti.numpy()[0, :11].tolist() == [3] + list(range(100, 110))


def test_rows_past_n_active_are_masked():
    q, e, bias = _inputs(2, 2, 32, 512, 3, "float32", False, n_dead=0)
    tv, ti = ttopk.topk_scores(*_torch(q, e, bias, "float32"), 3, k=10)
    jv, ji = jtopk.topk_scores(jnp.asarray(q), jnp.asarray(e),
                               jnp.asarray(bias), 3, k=10, impl="xla")
    assert np.all(tv.numpy()[:, 3:] == NEG_INF)
    assert set(ti.numpy()[0, :3].tolist()) == {0, 1, 2}
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy()[:, 3:], np.asarray(ji)[:, 3:])


def test_k_above_kernel_list_takes_counted_plain_route(caplog):
    """k > 128: the plain version, counted in the fallback metric and
    logged, with the same result as the JAX package's XLA route."""
    from archi_tpu_torch.utils.metrics import METRICS

    q, e, bias = _inputs(4, 3, 32, 512, 500, "float32", True)
    metric = METRICS.counter_value("archi_fused_topk_fallbacks_total")
    with caplog.at_level("WARNING"):
        tv, ti = ttopk.topk_scores(*_torch(q, e, bias, "float32"), 500, k=200)
    assert METRICS.counter_value("archi_fused_topk_fallbacks_total") \
        == metric + 1
    assert "k=200" in caplog.text
    jv, ji = jtopk.xla_topk(jnp.asarray(q), jnp.asarray(e), jnp.asarray(bias),
                            500, k=200)
    assert_same_topk(tv.numpy(), ti.numpy(), np.asarray(jv),
                     _exact_scores(q, e, bias, 500, "float32"))


def test_k_zero_and_k_clamped_to_corpus():
    q, e, bias = _inputs(1, 2, 8, 32, 32, "float32", False, n_dead=0)
    tv, ti = ttopk.topk_scores(*_torch(q, e, bias, "float32"), 32, k=0)
    assert tuple(tv.shape) == (2, 0) and tuple(ti.shape) == (2, 0)
    tv, ti = ttopk.topk_scores(*_torch(q, e, bias, "float32"), 32, k=50)
    assert tuple(tv.shape) == (2, 32)


def test_bias_helpers_match_reference():
    alive = np.array([1, 0, 1, 0.4, 0.6], np.float32)
    np.testing.assert_array_equal(
        ttopk.alive_to_bias(torch.from_numpy(alive)).numpy(),
        np.asarray(jtopk.alive_to_bias(jnp.asarray(alive))))
    for shape in ((5,), (3, 5)):
        b = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        for cap in (3, 5, 9):
            np.testing.assert_array_equal(
                ttopk.pad_bias_rows(torch.from_numpy(b), cap).numpy(),
                np.asarray(jtopk.pad_bias_rows(b, cap)))
    assert [ttopk.next_pow2(n) for n in (0, 1, 3, 8, 9)] == \
        [jtopk.next_pow2(n) for n in (0, 1, 3, 8, 9)]
