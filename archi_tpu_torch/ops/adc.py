"""PQ asymmetric-distance (ADC) scores: the CUDA kernels and their plain
PyTorch versions.

Counterpart of ``archi_tpu/ops/pallas_adc.py``.  For lookup tables
``luts [m, G, ksub]`` f32 and subspace-major codes both functions return
``scores [G, S]`` f32 with

    scores[g, s] = sum_j bf16(luts[j, g, code(j, s)])

summed in f32 over j = 0..m-1.  The table is rounded to bf16 first, as the
TPU kernels round it for their one-hot MXU contraction (``pallas_adc.py:50,
104, 161-163``): with that rounding the port equals the JAX functions, where
an f32-exact gather would differ from them by up to 2e-2.

``adc_scores`` takes 8-bit codes ``codes_t [m, S]`` u8; ``adc_scores_lut16``
takes ksub = 16 codes packed two to a byte, ``packed_t [m/2, S]`` u8 (low
nibble = even subspace).  Both launch ``csrc/adc.cu`` on CUDA tensors and
take the plain version on CPU tensors.  Codes must be below ksub.

Each launch is planned here: the query tile (``query_tile``, the queries a
CTA's shared table holds) and the columns a lane scores
(``columns_per_lane``: 8 or 4 on the vectorised route, 1 on the byte
route), counted under ``ops.ROUTE_LAUNCHES["<name>:vector" | "<name>:byte"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from archi_tpu_torch.ops import _build, count_launch


def round_lut(luts_mgk: torch.Tensor) -> torch.Tensor:
    """The table as the kernels read it: f32 rounded to bf16 (nearest
    even), held in f32."""
    return luts_mgk.float().to(torch.bfloat16).float()


def plain_adc_scores(luts_mgk, codes_t):
    """Plain version of ``adc_scores`` (and of the JAX package's
    ``adc_scores_xla``): one gather of the bf16-rounded table per subspace,
    added in subspace order."""
    lut = round_lut(luts_mgk)
    m, g, _ksub = lut.shape
    out = torch.zeros((g, codes_t.shape[1]), dtype=torch.float32,
                      device=codes_t.device)
    for j in range(m):
        out += lut[j][:, codes_t[j].long()]
    return out


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[N, m] uint8 4-bit codes → [N, m//2] packed (low nibble = even j)."""
    lo = codes[:, 0::2].to(torch.uint8)
    hi = codes[:, 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., m//2] packed → [..., m] uint8 codes (inverse of pack)."""
    lo = packed & 15
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def plain_adc_scores_lut16(luts_mgk, packed_t):
    """Plain version of ``adc_scores_lut16``: unpack, then the 8-bit plain
    version.  The TPU kernel sums eight subspaces inside one MXU dot, so
    it differs from this j-ordered sum by a few ulp."""
    return plain_adc_scores(luts_mgk, unpack_nibbles(packed_t.t()).t())


#: query tiles of the kernels (queries a CTA's shared table holds); G above
#: the largest is tiled
QUERY_TILES = (1, 2, 4, 8)
#: columns a lane scores on the vectorised route (8- and 4-byte code loads);
#: the byte route takes one column a lane
VECTOR_COLUMNS = (8, 4)
#: f32 sums a thread keeps at most (query tile x columns)
MAX_SUMS = 32
#: the wider load is taken where it still gives each SM this many busy
#: warps (``scripts/torch_adc_ablation.py`` times each width: on an H100,
#: 8-byte loads win at 360,448 columns, 4-byte at 131,072)
BUSY_WARPS_PER_SM = 8


def query_tile(g: int) -> int:
    """The kernel's query tile for G queries: the smallest that holds them,
    8 for G > 8."""
    return next(t for t in QUERY_TILES if t >= min(g, QUERY_TILES[-1]))


def columns_per_lane(s: int, g: int, codes_ptr: int, sms: int) -> int:
    """Columns a lane scores (the load width in bytes a code row): the
    widest of ``VECTOR_COLUMNS`` that divides S and the codes' address and
    still fills ``sms`` SMs with ``BUSY_WARPS_PER_SM`` warps of 32 lanes
    (else the narrowest that divides them); 1, the byte route, when none
    divides them."""
    gt = query_tile(g)
    fits = [c for c in VECTOR_COLUMNS
            if s % c == 0 and codes_ptr % c == 0 and c * gt <= MAX_SUMS]
    if not fits:
        return 1
    query_tiles = -(-g // gt)
    for c in fits:
        if -(-s // (32 * c)) * query_tiles >= BUSY_WARPS_PER_SM * sms:
            return c
    return fits[-1]


def route(columns: int) -> str:
    """``ops.ROUTE_LAUNCHES`` route of a launch: ``vector`` (8- or 4-byte
    code loads) or ``byte``."""
    return "vector" if columns > 1 else "byte"


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("adc")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.archi_adc_scores.restype = i
        lib.archi_adc_scores.argtypes = [vp, vp, vp, i, i, i, ll, i, i, vp]
        lib.archi_adc_scores_lut16.restype = i
        lib.archi_adc_scores_lut16.argtypes = [vp, vp, vp, i, i, ll, i, i, vp]
        lib.archi_adc_error_string.restype = ctypes.c_char_p
        lib.archi_adc_error_string.argtypes = [i]
        _lib = lib
    return _lib


def _checked(name, luts_mgk, codes, code_rows):
    """Validate a CUDA call; returns (luts f32 contiguous, codes contiguous,
    m, G, ksub, S)."""
    if luts_mgk.dim() != 3 or codes.dim() != 2:
        raise ValueError(f"{name}: luts {tuple(luts_mgk.shape)}, codes "
                         f"{tuple(codes.shape)}; expected [m, G, ksub], [rows, S]")
    if codes.dtype != torch.uint8:
        raise TypeError(f"{name}: codes must be uint8, got {codes.dtype}")
    m, g, ksub = luts_mgk.shape
    if codes.shape[0] != code_rows(m):
        raise ValueError(f"{name}: {codes.shape[0]} code rows for m={m}")
    if luts_mgk.device != codes.device:
        raise ValueError(f"{name}: luts on {luts_mgk.device}, codes on "
                         f"{codes.device}")
    luts = luts_mgk.float().contiguous()
    if luts.data_ptr() % 16:   # the kernel reads the table as float4
        luts = luts.clone()
    return luts, codes.contiguous(), m, g, ksub, codes.shape[1]


@functools.cache
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, for the launch plan (cached: the
    property query costs host time, and the ANN paths are host-bound)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(name, fn, args, g, codes, lib):
    """Launch with the query tile and columns a lane planned for this input;
    raises if the kernel is refused."""
    dev = codes.device
    cols = columns_per_lane(codes.shape[1], g, codes.data_ptr(),
                            _sm_count(dev.index))
    with torch.cuda.device(dev):
        rc = fn(*args, query_tile(g), cols,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: {lib.archi_adc_error_string(rc).decode()} "
                           f"(error {rc})")
    count_launch(name, route(cols))


def adc_scores(luts_mgk, codes_t):
    """8-bit ADC scores [G, S] f32.

    Args:
      luts_mgk: [m, G, ksub] float, ksub <= 256.
      codes_t: [m, S] uint8, every code < ksub; any S >= 0.
    CPU tensors take ``plain_adc_scores``."""
    if codes_t.device.type == "cpu":
        return plain_adc_scores(luts_mgk, codes_t)
    if codes_t.device.type != "cuda":
        raise ValueError(f"adc_scores: unsupported device {codes_t.device}")
    luts, codes, m, g, ksub, s = _checked("adc_scores", luts_mgk, codes_t,
                                          lambda m: m)
    if ksub > 256:
        raise ValueError(f"adc_scores: ksub={ksub} > 256")
    out = torch.empty((g, s), dtype=torch.float32, device=codes.device)
    if m == 0 or g == 0 or s == 0:
        return out.zero_()
    lib = _kernel()
    _launch("adc_scores", lib.archi_adc_scores,
            (luts.data_ptr(), codes.data_ptr(), out.data_ptr(), m, g, ksub, s),
            g, codes, lib)
    return out


def adc_scores_lut16(luts_mgk, packed_t):
    """4-bit ADC scores [G, S] f32.

    Args:
      luts_mgk: [m, G, 16] float, m even.
      packed_t: [m/2, S] uint8, two codes a byte (low nibble = subspace 2b).
    CPU tensors take ``plain_adc_scores_lut16``."""
    if packed_t.device.type == "cpu":
        return plain_adc_scores_lut16(luts_mgk, packed_t)
    if packed_t.device.type != "cuda":
        raise ValueError(f"adc_scores_lut16: unsupported device {packed_t.device}")
    luts, codes, m, g, ksub, s = _checked("adc_scores_lut16", luts_mgk,
                                          packed_t, lambda m: m // 2)
    if ksub != 16 or m % 2:
        raise ValueError(f"adc_scores_lut16: needs ksub 16 and even m, got "
                         f"m={m}, ksub={ksub}")
    out = torch.empty((g, s), dtype=torch.float32, device=codes.device)
    if m == 0 or g == 0 or s == 0:
        return out.zero_()
    lib = _kernel()
    _launch("adc_scores_lut16", lib.archi_adc_scores_lut16,
            (luts.data_ptr(), codes.data_ptr(), out.data_ptr(), m, g, s),
            g, codes, lib)
    return out
