"""The port's ADC scoring (plain versions, as the CPU wrappers take them)
against the JAX package's ``archi_tpu/ops/pallas_adc.py``.

Same numpy tables and codes through the Pallas kernels in interpret mode,
``adc_scores_xla`` and the port's ``adc_scores`` / ``adc_scores_lut16`` on
CPU tensors, at atol 1e-5.  The 8-bit plain version sums the bf16-rounded
table in subspace order, as the interpreted kernel and ``adc_scores_xla``
do; the 4-bit kernel sums eight subspaces inside one dot, a few ulp away.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.ops import pallas_adc as jadc
from archi_tpu_torch.ops import adc as tadc

ATOL = 1e-5


def _case(seed, m, g, s, ksub):
    rng = np.random.default_rng(seed)
    luts = rng.standard_normal((m, g, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (m, s)).astype(np.uint8)
    return luts, codes


@pytest.mark.parametrize("m,g,s", [(8, 1, 2048), (16, 4, 4096), (12, 3, 6144),
                                   (48, 2, 2048)])
def test_adc_scores_matches_pallas_interpret_and_xla(m, g, s):
    luts, codes = _case(m + g, m, g, s, 256)
    want_k = np.asarray(jadc.adc_scores(jnp.asarray(luts), jnp.asarray(codes),
                                        tile=2048, interpret=True))
    want_x = np.asarray(jadc.adc_scores_xla(jnp.asarray(luts),
                                            jnp.asarray(codes)))
    got = tadc.adc_scores(torch.from_numpy(luts), torch.from_numpy(codes))
    assert got.dtype == torch.float32 and tuple(got.shape) == (g, s)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_x, rtol=0, atol=ATOL)


@pytest.mark.parametrize("m,g,s", [(8, 1, 2048), (16, 2, 4096), (48, 3, 2048)])
def test_adc_scores_lut16_matches_pallas_interpret(m, g, s):
    luts, codes = _case(7 * m + g, m, g, s, 16)
    packed_t = np.asarray(jadc.pack_nibbles(codes.T)).T.copy()
    want_k = np.asarray(jadc.adc_scores_lut16(
        jnp.asarray(luts), jnp.asarray(packed_t), tile=2048, interpret=True))
    want_x = np.asarray(jadc.adc_scores_xla(jnp.asarray(luts),
                                            jnp.asarray(codes)))
    got = tadc.adc_scores_lut16(torch.from_numpy(luts),
                                torch.from_numpy(packed_t))
    np.testing.assert_allclose(got.numpy(), want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_x, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [1, 999, 1001])
def test_plain_versions_take_any_candidate_count(s):
    """The TPU kernels need S % tile == 0; the port takes any S (here
    against adc_scores_xla, which has no tiling)."""
    luts, codes = _case(s, 16, 2, s, 16)
    want = np.asarray(jadc.adc_scores_xla(jnp.asarray(luts), jnp.asarray(codes)))
    got8 = tadc.adc_scores(torch.from_numpy(luts), torch.from_numpy(codes))
    packed_t = tadc.pack_nibbles(torch.from_numpy(codes).t()).t()
    got4 = tadc.adc_scores_lut16(torch.from_numpy(luts), packed_t)
    np.testing.assert_allclose(got8.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got4.numpy(), want, rtol=0, atol=ATOL)


def test_lut_is_rounded_to_bf16_before_the_sum():
    """An f32-exact gather differs from the JAX functions by the bf16
    rounding of the table; the port does not."""
    luts, codes = _case(3, 48, 1, 4096, 256)
    want = np.asarray(jadc.adc_scores_xla(jnp.asarray(luts), jnp.asarray(codes)))
    exact = sum(luts[j][:, codes[j]] for j in range(48))
    got = tadc.adc_scores(torch.from_numpy(luts), torch.from_numpy(codes))
    assert np.abs(exact - want).max() > 10 * ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        tadc.round_lut(torch.from_numpy(luts)).numpy(),
        np.asarray(jnp.asarray(luts).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 8), (1, 2), (33, 48)])
def test_pack_unpack_round_trip_equals_jax(shape):
    codes = np.random.default_rng(shape[0]).integers(0, 16, shape).astype(
        np.uint8)
    packed = tadc.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jadc.pack_nibbles(codes)))
    unpacked = tadc.unpack_nibbles(packed)
    np.testing.assert_array_equal(unpacked.numpy(), codes)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jadc.unpack_nibbles(packed.numpy())))
    # leading axes ride along, as in the JAX function
    three = packed.reshape(1, *packed.shape)
    np.testing.assert_array_equal(tadc.unpack_nibbles(three).numpy()[0], codes)
