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


# ---------------------------------------------------------------- launch plan
@pytest.mark.parametrize("g,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                    (8, 8), (9, 8), (256, 8)])
def test_query_tile(g, want):
    assert tadc.query_tile(g) == want


@pytest.mark.parametrize("s,g,ptr,want", [
    (360_448, 1, 0, 8),       # path A: 1408 warp tiles, 10.7 an SM
    (131_072, 2, 0, 4),       # path B: 4 columns, the most warps
    (1 << 24, 1, 0, 8),       # many columns: the widest load
    (1 << 24, 4, 0, 8),       # query tile 4: at most 8 columns (32 sums)
    (1 << 24, 256, 0, 4),     # query tile 8: at most 4 columns
    (1 << 24, 1, 8, 8),       # an address aligned to 8
    (1 << 24, 1, 4, 4),       # aligned to 4 but not 8
    (1 << 24, 1, 2, 1),       # unaligned codes: the byte route
    (1 << 24, 1, 1, 1),
    (16, 2, 0, 4),            # few columns: the narrowest vector load
    (15, 2, 0, 1),            # S the 4-byte loads do not divide
    (17, 1, 0, 1),
    (1, 1, 0, 1),
    ((1 << 17) + 4, 2, 0, 4),
    ((1 << 17) + 3, 2, 0, 1),
])
def test_columns_per_lane_and_route(s, g, ptr, want):
    """The widest load that divides S and the codes' address and still
    gives 132 SMs 8 busy warps each; the byte route when none divides."""
    cols = tadc.columns_per_lane(s, g, ptr, 132)
    assert cols == want
    assert tadc.route(cols) == ("byte" if want == 1 else "vector")
    assert s % cols == 0 and ptr % cols == 0
    assert cols * tadc.query_tile(g) <= tadc.MAX_SUMS


def _kernel_model(luts, codes, packed, run):
    """The design of ``csrc/adc.cu`` in numpy: the table as it holds it in
    shared memory ([j][c][g] bf16, the queries of a tile side by side, zero
    past G, one 32-bit word a pair of queries), looked up a word at a time,
    halves turned into f32 by shifts, summed in f32 in subspace order, runs
    of ``run`` subspaces added to the scores of the runs before."""
    m, g, ksub = luts.shape
    gt = tadc.query_tile(g)
    n_tiles = -(-g // gt)
    bits = (tadc.round_lut(torch.from_numpy(luts)).numpy().view(np.uint32)
            >> 16).astype(np.uint32)                      # [m, G, ksub]
    bits = np.concatenate([bits, np.zeros((m, n_tiles * gt - g, ksub),
                                          np.uint32)], axis=1)
    if packed:
        codes = np.stack([codes & 15, codes >> 4], axis=1).reshape(m, -1)
    out = np.zeros((n_tiles * gt, codes.shape[1]), np.float32)
    for t in range(n_tiles):
        tab = bits[:, t * gt:(t + 1) * gt, :].transpose(0, 2, 1)   # [j][c][g]
        if gt == 1:
            words, halves = tab[..., 0] << 16, [lambda w: w]
        else:
            words = tab[..., 0::2] | (tab[..., 1::2] << 16)         # pairs
            halves = [lambda w: w << 16, lambda w: w & 0xFFFF0000]
        for j0 in range(0, m, run):
            acc = out[t * gt:(t + 1) * gt].copy()
            for j in range(j0, min(m, j0 + run)):
                entry = words[j][codes[j]]                  # [S] or [S, gt/2]
                for q in range(gt):
                    w = entry if gt == 1 else entry[:, q // 2]
                    acc[q] += halves[q % 2 if gt > 1 else 0](
                        w.astype(np.uint32)).view(np.float32)
            out[t * gt:(t + 1) * gt] = acc
    return out[:g]


@pytest.mark.parametrize("m,g,s,packed,run", [
    (8, 1, 2048, False, 8), (16, 3, 2048, False, 5), (12, 9, 2048, False, 12),
    (8, 2, 2048, True, 8), (16, 5, 2048, True, 4), (48, 2, 2048, True, 48)])
def test_kernel_table_layout_matches_jax(m, g, s, packed, run):
    """A check of the design, not of the kernel: the shared-memory layout
    and lookup arithmetic that ``csrc/adc.cu`` implements, modelled in
    numpy, give the JAX functions' scores (Pallas kernels interpreted and
    ``adc_scores_xla``): pair words, zero-padded query tiles, nibble order
    and subspace runs change no bit of the f32 sum.  The kernel itself is
    held against the plain versions on the card (``test_torch_cuda.py``)."""
    luts, codes = _case(31 * m + g, m, g, s, 16 if packed else 256)
    want_x = np.asarray(jadc.adc_scores_xla(jnp.asarray(luts),
                                            jnp.asarray(codes)))
    if packed:
        codes = np.asarray(jadc.pack_nibbles(codes.T)).T.copy()
        want_k = np.asarray(jadc.adc_scores_lut16(
            jnp.asarray(luts), jnp.asarray(codes), tile=2048, interpret=True))
    else:
        want_k = np.asarray(jadc.adc_scores(jnp.asarray(luts), jnp.asarray(codes),
                                            tile=2048, interpret=True))
    got = _kernel_model(luts, codes, packed, run)
    np.testing.assert_allclose(got, want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_x, rtol=0, atol=ATOL)
    plain = (tadc.plain_adc_scores_lut16 if packed else tadc.plain_adc_scores)(
        torch.from_numpy(luts), torch.from_numpy(codes))
    np.testing.assert_array_equal(got, plain.numpy())
