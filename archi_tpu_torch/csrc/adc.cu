// PQ asymmetric-distance (ADC) scores over 8-bit and packed 4-bit codes
// (CUDA C++, sm_90a).
//
// Replaces the TPU kernels `adc_scores` (body `_adc_kernel`) and
// `adc_scores_lut16` (body `_adc_lut16_kernel`) in archi_tpu/ops/pallas_adc.py.
// For per-query lookup tables luts [m, G, ksub] f32 and subspace-major codes
// codes_t [m, S] u8 (8-bit) or packed_t [m/2, S] u8 (two 4-bit codes a byte,
// low nibble = even subspace) both compute
//
//     scores[g, s] = sum_{j = 0 .. m-1} bf16(luts[j, g, code(j, s)])
//
// with the table rounded to bf16 (round to nearest even) as the TPU kernels
// round it before their one-hot MXU contraction, and the sum taken in f32 in
// the order j = 0, 1, ..., m-1.  A one-hot product picks one bf16 entry
// exactly, so this is the TPU kernel's function; it is not its one-hot
// formulation, which on Hopper would spend ksub multiply-adds per entry.
//
// What bounds it on an H100: each code byte is read once (S * m bytes, or
// S * m / 2 packed) and each score written once (G * S * 4 bytes); the table
// is small (m * ksub * 2 bytes a query, 24 KB at m = 48, ksub = 256).  At
// the IVF-PQ shapes (G <= 4) the bytes bound it: 3.6e5 candidates x 48
// codes is 17 MB, 5 us at 3.35 TB/s.  The work per byte is G table lookups
// in shared memory, the limit once G grows (adc_topk passes G = batch).
//
// Design.  The TPU kernel keeps the whole [m, G, ksub] table in VMEM and
// walks candidate tiles in order.  Here a CTA copies the bf16 table of
// GT <= 8 queries (for a run of subspaces, when one query's table exceeds
// the shared-memory budget) into shared memory with 16-byte loads, then
// walks candidate columns in a grid-stride loop.  A thread takes 4
// consecutive columns and reads them as one 32-bit word per subspace (a
// warp reads 128 contiguous bytes); it loads 8 subspaces' words before it
// looks any of them up, so 8 loads are in flight; it keeps 4 x GT f32 sums
// in registers.  A row length S that is not a multiple of 4 takes the same
// loop with one column a thread and byte loads.  The grid is one wave of
// CTAs over columns (x) and query tiles (y), so each CTA's table copy is
// spread over as many columns as the card allows.  A table larger than the
// budget is split into runs of subspaces, one launch each, the later launches
// adding to the scores of the earlier ones, so the sum keeps the order
// j = 0..m-1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGT = 8;                        // queries per CTA
constexpr int kSmemBudget = 96 * 1024;           // two CTAs per SM
constexpr int kPrefetch = 8;                     // code words in flight

template <int CPT>
struct Word;
template <>
struct Word<4> {
  using T = uint32_t;
};
template <>
struct Word<1> {
  using T = uint8_t;
};

// Scores of candidates against queries [g0, g0 + gt) over subspaces
// [j0, j0 + mc).  Shared table layout: [j][g][c] (the global order).
// PACKED: codes are nibbles, two subspaces a byte (ksub 16).  CPT: columns
// a thread (4 needs S % 4 == 0 and a 4-byte aligned codes pointer).
template <bool PACKED, int CPT>
__global__ void __launch_bounds__(kThreads)
adc_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
           float* __restrict__ out, int G, int ksub, long long S, int j0,
           int mc, int accumulate) {
  using W = typename Word<CPT>::T;
  extern __shared__ __nv_bfloat16 lut_s[];       // [mc][gt][ksub]
  const int g0 = blockIdx.y * kMaxGT;
  const int gt = min(kMaxGT, G - g0);
  const int rows = mc * gt;
  if ((ksub & 3) == 0) {
    const int q4 = ksub >> 2;                    // float4s a table row
    for (int i = threadIdx.x; i < rows * q4; i += blockDim.x) {
      const int r = i / q4;
      const int c = (i - r * q4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          luts + (static_cast<long long>(j0 + r / gt) * G + g0 + r % gt) * ksub + c);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(lut_s + r * ksub + c);
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * ksub; i += blockDim.x) {
      const int r = i / ksub;
      const int c = i - r * ksub;
      lut_s[i] = __float2bfloat16_rn(
          luts[(static_cast<long long>(j0 + r / gt) * G + g0 + r % gt) * ksub + c]);
    }
  }
  __syncthreads();

  // code rows of this run: subspaces, or packed bytes (two subspaces each)
  const int n_rows = PACKED ? mc / 2 : mc;
  const uint8_t* base = codes + static_cast<long long>(PACKED ? j0 / 2 : j0) * S;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * CPT;
  for (long long s = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * CPT;
       s < S; s += stride) {
    float acc[kMaxGT][CPT];
#pragma unroll
    for (int g = 0; g < kMaxGT; ++g)
#pragma unroll
      for (int t = 0; t < CPT; ++t)
        acc[g][t] = (accumulate && g < gt) ? out[(g0 + g) * S + s + t] : 0.0f;
    for (int r0 = 0; r0 < n_rows; r0 += kPrefetch) {
      W w[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u)
        if (r0 + u < n_rows)
          w[u] = *reinterpret_cast<const W*>(base + (r0 + u) * S + s);
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (r0 + u >= n_rows) break;
        const int r = r0 + u;
#pragma unroll
        for (int t = 0; t < CPT; ++t) {
          const int byte = (w[u] >> (8 * t)) & 0xff;
          if (PACKED) {
            // subspaces 2r (low nibble) then 2r + 1 (high nibble)
            const __nv_bfloat16* lo = lut_s + (2 * r) * gt * 16 + (byte & 15);
            const __nv_bfloat16* hi = lut_s + (2 * r + 1) * gt * 16 + (byte >> 4);
#pragma unroll
            for (int g = 0; g < kMaxGT; ++g) {
              if (g < gt) {
                acc[g][t] += __bfloat162float(lo[g * 16]);
                acc[g][t] += __bfloat162float(hi[g * 16]);
              }
            }
          } else {
            const __nv_bfloat16* e = lut_s + r * gt * ksub + byte;
#pragma unroll
            for (int g = 0; g < kMaxGT; ++g)
              if (g < gt) acc[g][t] += __bfloat162float(e[g * ksub]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGT; ++g)
#pragma unroll
      for (int t = 0; t < CPT; ++t)
        if (g < gt) out[(g0 + g) * S + s + t] = acc[g][t];
  }
}

template <bool PACKED, int CPT>
int launch_t(const float* luts, const uint8_t* codes, float* out, int m, int G,
             int ksub, long long S, int gt, int mc, cudaStream_t stream) {
  auto kernel = adc_kernel<PACKED, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  const size_t smem = static_cast<size_t>(gt) * mc * ksub * 2;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  // one wave of CTAs in all; each walks its columns grid-stride
  const int gy = (G + kMaxGT - 1) / kMaxGT;
  if (gy > 65535) return cudaErrorInvalidValue;
  long long gx = (static_cast<long long>(sms) * occ + gy - 1) / gy;
  const long long col_tiles = (S + kThreads * CPT - 1) / (kThreads * CPT);
  if (gx > col_tiles) gx = col_tiles;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  for (int j0 = 0; j0 < m; j0 += mc) {
    const int run = (m - j0) < mc ? (m - j0) : mc;
    kernel<<<grid, kThreads, static_cast<size_t>(gt) * run * ksub * 2, stream>>>(
        luts, codes, out, G, ksub, S, j0, run, j0 > 0 ? 1 : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool PACKED>
int launch(const float* luts, const uint8_t* codes, float* out, int m, int G,
           int ksub, long long S, cudaStream_t stream) {
  if (m < 1 || G < 1 || S < 1 || ksub < 1 || ksub > 256) return cudaErrorInvalidValue;
  if (PACKED && (ksub != 16 || m % 2)) return cudaErrorInvalidValue;
  if ((ksub & 3) == 0 && reinterpret_cast<uintptr_t>(luts) % 16)
    return cudaErrorMisalignedAddress;
  const int gt = G < kMaxGT ? G : kMaxGT;
  // subspaces per launch: the whole table when GT queries' tables fit
  int mc = kSmemBudget / (gt * ksub * 2);
  if (PACKED) mc -= mc % 2;
  if (mc < (PACKED ? 2 : 1)) return cudaErrorInvalidValue;
  if (mc > m) mc = m;
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  return vec ? launch_t<PACKED, 4>(luts, codes, out, m, G, ksub, S, gt, mc, stream)
             : launch_t<PACKED, 1>(luts, codes, out, m, G, ksub, S, gt, mc, stream);
}

}  // namespace

extern "C" {

// luts [m, G, ksub] f32 (16-byte aligned when ksub % 4 == 0),
// codes_t [m, S] u8 -> out [G, S] f32.
int archi_adc_scores(const float* luts, const uint8_t* codes_t, float* out, int m,
                     int G, int ksub, long long S, void* stream) {
  return launch<false>(luts, codes_t, out, m, G, ksub, S,
                       static_cast<cudaStream_t>(stream));
}

// luts [m, G, 16] f32 (16-byte aligned), packed_t [m/2, S] u8 -> out [G, S] f32.
int archi_adc_scores_lut16(const float* luts, const uint8_t* packed_t, float* out,
                           int m, int G, long long S, void* stream) {
  return launch<true>(luts, packed_t, out, m, G, 16, S,
                      static_cast<cudaStream_t>(stream));
}

const char* archi_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
