// Fused score + top-k scan for the flat index (CUDA C++, sm_90a).
//
// Replaces the TPU kernel `fused_topk` in archi_tpu/ops/pallas_topk.py
// (body `_fused_topk_kernel`, merge `_topk_update`).  For queries Q [B, D]
// and a corpus E [n_pad, D] it returns the top-k (k <= 128) of
// q . E[i] + bias[i] per query, with rows >= n_active scored NEG_INF, and
// never writes the [B, n_pad] score matrix to device memory.  Equal scores
// rank the lower row first, as lax.top_k and the first-argmax merge of the
// TPU kernel do.
//
// What bounds it on an H100: at the flat index's shapes (n_active = 2^20,
// D = 384, bf16) one scan reads the 805 MB of live rows, 0.24 ms at
// 3.35 TB/s; a per-query bias [B, n_pad] f32 adds 4 MB of live entries per
// query (1 GiB at B = 256, more than the corpus).  The products are
// 2 * B * n_active * D operations: 0.03 ms at B = 32 and 0.21 ms at
// B = 256 on the bf16 tensor cores (989 TFLOP/s), under the bytes; on the
// CUDA cores in f32 (67 TFLOP/s) they are 0.39 and 3.1 ms, above them from
// B of about 20 up.  So bf16 and int8 corpora are scored on the tensor
// cores; f32 corpora stay on the CUDA cores, where TF32 would not hold the
// 1e-4 agreement with the plain version.
//
// Design.  The TPU kernel walks the tiles in order on one core and carries
// a running [B, 128] top-k in scratch.  CTAs on Hopper run in parallel and
// in no order, so the scan is two passes:
//   pass 1: grid (query block, corpus split); the splits cover the live
//     rows [0, n_active) only, so an index whose capacity is well above its
//     rows (a power of two) costs nothing more.  Query blocks are the
//     fastest grid axis, so the CTAs that read one split run together and
//     share it through L2.  Each CTA streams its split in 128-row tiles and
//     keeps a sorted k-list per query in shared memory.
//     - bf16 / int8 (tc_topk_partial_kernel): QB (8 or 32) queries sit
//       in shared memory in the corpus type, rows padded by 16 bytes.  The
//       tiles arrive 128 bytes of depth at a time through a ring of 6
//       stages (3 where only that lets two CTAs share an SM) of
//       cp.async copies (16 bytes a thread), swizzled (16-byte piece
//       u of row r at u ^ (r & 7)) so the ldmatrix loads are conflict
//       free; a D that is not a multiple of the 128 bytes is zero-filled.
//       Each of the 8 warps takes 16 rows of the tile as the M side of
//       mma.sync (m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32, exact) and
//       the QB queries as N.  Epilogue: scale (__fmul_rn), then the bias,
//       read into registers at the start of the tile, 32 contiguous bytes
//       of rows per query; each score is gated against its query's k-th
//       entry in registers, and the survivors go to a per-query candidate
//       buffer in shared memory, which each warp merges into the k-lists of
//       its queries after the tile (for k <= 32 with the list held one entry
//       a lane in registers).  Once a list is full the survivors are rare.
//     - f32 (topk_partial_kernel): QB (8 or 32) queries in shared memory
//       as f32, 128-row tiles in 32-deep chunks (the next chunk is loaded
//       into registers while the current one is used), scalar fmaf, each
//       warp holding the dot products of its own queries in registers and
//       offering its 128 candidate rows to their k-lists (a ballot against
//       the list's last entry).
//   pass 2 (topk_merge_kernel): one warp per query merges the splits'
//     lists into the final [B, k], then offers the rows past n_active at
//     NEG_INF.  Only the first k of them (n_active .. n_active + k - 1) can
//     rank, so those k stand for all of them: a list with fewer than k
//     live rows above NEG_INF fills with them, lowest row first, exactly
//     as a sort of the full masked score row would.
// bf16 products are exact in f32, so the scores differ from an f32 product
// of the bf16-rounded operands only by the order of the sum.  int8 rows and
// queries (clip(round(127 x))) are summed exactly as int32 and scaled by
// 1/127^2 as the TPU kernel's int32 product is; the plain version sums them
// in f32, exact while D * 127^2 < 2^24 (D <= 1040, checked by the wrapper),
// so both give the same scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                 // rows per tile: 32 lanes x 4
constexpr int kRowsPerLane = kTileN / 32;
constexpr int kBK = 32;                     // depth of one shared-memory chunk
constexpr int kEStride = kBK + 4;           // padded row stride (floats)
constexpr int kMaxK = 128;
constexpr float kNegInf = -1.0e30f;         // NEG_INF of the JAX package

// 16 consecutive elements at a 16-byte aligned address, as f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = s[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// (v, i) ranks above (w, j): the higher score first, the lower row on ties.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Warp-cooperative insertion of (v, r) into the sorted list (lv, li) of
// length k.  Every lane passes the same (v, r), which ranks above the
// list's last entry.
__device__ void list_insert(float* lv, int* li, int k, float v, int r) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += better(lv[j], li[j], v, r) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  const int p = cnt;  // entries that stay ahead of (v, r)
  float tv[kMaxK / 32];
  int ti[kMaxK / 32];
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) {
    const int j = lane + 32 * s;
    if (j > p && j < k) { tv[s] = lv[j - 1]; ti[s] = li[j - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) {
    const int j = lane + 32 * s;
    if (j > p && j < k) { lv[j] = tv[s]; li[j] = ti[s]; }
  }
  if (lane == 0) { lv[p] = v; li[p] = r; }
  __syncwarp();
}

// Each lane offers one candidate; those that rank above the list's last
// entry (thr_v, thr_i — warp-uniform, kept in registers) are inserted in
// lane order.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k, float v,
                                           int r, bool valid, float& thr_v,
                                           int& thr_i) {
  unsigned m = __ballot_sync(0xffffffffu, valid && better(v, r, thr_v, thr_i));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int cr = __shfl_sync(0xffffffffu, r, src);
    if (better(cv, cr, thr_v, thr_i)) {
      list_insert(lv, li, k, cv, cr);
      thr_v = lv[k - 1];
      thr_i = li[k - 1];
    }
  }
}

// Merges n candidates (cv, ci) into the sorted list (lv, li) of length
// k <= 32, which the warp holds one entry a lane in registers meanwhile: an
// insertion is a ballot for its position and a shuffle of the entries below.
__device__ void merge_small(float* lv, int* li, int k, const float* cv, const int* ci, int n) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float v = lane < k ? lv[lane] : -INFINITY;
  int r = lane < k ? li[lane] : INT_MAX;
  float thr_v = __shfl_sync(all, v, k - 1);
  int thr_i = __shfl_sync(all, r, k - 1);
  for (int base = 0; base < n; base += 32) {
    const int x = base + lane;
    const bool valid = x < n;
    const float cvv = valid ? cv[x] : -INFINITY;
    const int cii = valid ? ci[x] : INT_MAX;
    unsigned m = __ballot_sync(all, valid && better(cvv, cii, thr_v, thr_i));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float nv = __shfl_sync(all, cvv, src);
      const int ni = __shfl_sync(all, cii, src);
      if (!better(nv, ni, thr_v, thr_i)) continue;  // warp-uniform
      // the entries ahead of (nv, ni) are a prefix of the sorted list
      const int p = __popc(__ballot_sync(all, lane < k && better(v, r, nv, ni)));
      const float up_v = __shfl_up_sync(all, v, 1);
      const int up_r = __shfl_up_sync(all, r, 1);
      if (lane > p) { v = up_v; r = up_r; }
      if (lane == p) { v = nv; r = ni; }
      thr_v = __shfl_sync(all, v, k - 1);
      thr_i = __shfl_sync(all, r, k - 1);
    }
  }
  if (lane < k) { lv[lane] = v; li[lane] = r; }
  __syncwarp();
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t partial_smem_bytes(int qb, int d, int k) {
  return sizeof(float) * (static_cast<size_t>(qb) * round_up(d, kBK) +
                          kTileN * kEStride) +
         static_cast<size_t>(qb) * k * (sizeof(float) + sizeof(int));
}

template <int QB>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ e,
                    const float* __restrict__ bias, int bias_stride, int B,
                    int D, int n_active, int k, int rows_per_split,
                    float scale, int vec, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  constexpr int RQ = QB / kWarps;  // queries per warp
  extern __shared__ __align__(16) float smem[];
  const int Dp = round_up(D, kBK);
  float* qs = smem;                          // [QB][Dp]
  float* es = qs + QB * Dp;                  // [kTileN][kEStride]
  float* lv = es + kTileN * kEStride;        // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y, splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_active, row_begin + rows_per_split);

  for (int x = tid; x < QB * Dp; x += kThreads) {
    const int qi = x / Dp, d = x - qi * Dp;
    qs[x] = (q0 + qi < B && d < D) ? q[static_cast<size_t>(q0 + qi) * D + d] : 0.f;
  }
  for (int x = tid; x < QB * k; x += kThreads) { lv[x] = -INFINITY; li[x] = INT_MAX; }
  __syncthreads();

  float thr_v[RQ];
  int thr_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) { thr_v[i] = -INFINITY; thr_i[i] = INT_MAX; }

  // chunk loader: thread -> (tile row tid/2, 16 columns at (tid&1)*16)
  const int ld_r = tid >> 1, ld_c = (tid & 1) * 16;
  float pre[16];
  auto load_chunk = [&](int t0, int k0) {
    const int row = t0 + ld_r;
    const int col = k0 + ld_c;
    if (row >= row_end) {
#pragma unroll
      for (int c = 0; c < 16; ++c) pre[c] = 0.f;
    } else if (vec) {
      load16(e + static_cast<size_t>(row) * D + col, pre);
    } else {
      const float* src = e + static_cast<size_t>(row) * D;
#pragma unroll
      for (int c = 0; c < 16; ++c) pre[c] = (col + c < D) ? src[col + c] : 0.f;
    }
  };

  for (int t0 = row_begin; t0 < row_end; t0 += kTileN) {
    float acc[RQ][kRowsPerLane];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;

    load_chunk(t0, 0);
    for (int k0 = 0; k0 < Dp; k0 += kBK) {
      float4* dst = reinterpret_cast<float4*>(es + ld_r * kEStride + ld_c);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[c] = make_float4(pre[4 * c], pre[4 * c + 1], pre[4 * c + 2], pre[4 * c + 3]);
      __syncthreads();
      if (k0 + kBK < Dp) load_chunk(t0, k0 + kBK);  // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 qv[RQ], ev[kRowsPerLane];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (warp * RQ + i) * Dp + k0 + kk);
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          ev[j] = *reinterpret_cast<const float4*>(es + (lane + 32 * j) * kEStride + kk);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            float a = acc[i][j];
            a = fmaf(qv[i].x, ev[j].x, a);
            a = fmaf(qv[i].y, ev[j].y, a);
            a = fmaf(qv[i].z, ev[j].z, a);
            a = fmaf(qv[i].w, ev[j].w, a);
            acc[i][j] = a;
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = warp * RQ + i;
      const int qg = q0 + qi;
      if (qg >= B) break;  // warp-uniform
      const float* brow = bias + static_cast<size_t>(qg) * bias_stride;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = t0 + lane + 32 * j;
        const bool live = row < row_end;
        // the product rounds before the bias is added (no FMA), as in the
        // plain version and the TPU kernel
        const float v = live ? __fmul_rn(acc[i][j], scale) + brow[row] : -INFINITY;
        warp_offer(lv + qi * k, li + qi * k, k, v, row, live, thr_v[i], thr_i[i]);
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < QB * k; x += kThreads) {
    const int qi = x / k, j = x - qi * k;
    const int qg = q0 + qi;
    if (qg < B) {
      const size_t o = (static_cast<size_t>(qg) * splits + split) * k + j;
      part_v[o] = lv[x];
      part_i[o] = li[x];
    }
  }
}

// ------------------------------------------------- bf16 / int8, tensor cores
constexpr int kDeepRing = 6;                      // cp.async ring depths:
constexpr int kShallowRing = 3;                   // see tc_route
constexpr int kChunkB = 128;                      // bytes of depth a stage
constexpr int kStageB = kTileN * kChunkB;         // 16 KB a stage
constexpr int kLoadsPerThread = kStageB / 16 / kThreads;

// shared memory of tc_topk_partial_kernel: ring, queries, k-lists,
// candidate buffers and their counts
size_t tc_smem_bytes(int stages, int qb, int d, int esize, int k) {
  const size_t qrow = static_cast<size_t>(round_up(d * esize, kChunkB)) + 16;
  return static_cast<size_t>(stages) * kStageB + qb * qrow +
         static_cast<size_t>(qb) * k * 8 + static_cast<size_t>(qb) * kTileN * 8 +
         static_cast<size_t>(qb) * 4;
}

template <typename T, int QB, bool PER_QUERY, int NS>
__global__ void __launch_bounds__(kThreads, 1)  // shared memory allows 1-2 CTAs
tc_topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ e,
                       const float* __restrict__ bias, int bias_stride, int B,
                       int D, int n_active, int k, int rows_per_split,
                       float scale, int vec, float* __restrict__ part_v,
                       int* __restrict__ part_i) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int NT = QB / 8;  // 8-query tiles of the N side
  extern __shared__ __align__(16) float smem[];  // as the other kernels
  const int RB = D * static_cast<int>(sizeof(T));  // bytes of a row
  const int nch = (RB + kChunkB - 1) / kChunkB;     // stages a tile
  const int QSB = nch * kChunkB + 16;               // query row in shared
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  unsigned char* qs = ring + NS * kStageB;
  float* lv = reinterpret_cast<float*>(qs + QB * QSB);  // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);    // [QB][kTileN]
  int* ci = reinterpret_cast<int*>(cv + QB * kTileN);
  int* cnt = ci + QB * kTileN;                          // [QB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y, splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_active, row_begin + rows_per_split);
  const int ntiles = row_end > row_begin ? (row_end - row_begin + kTileN - 1) / kTileN : 0;
  const int nsteps = ntiles * nch;
  const unsigned char* eb = reinterpret_cast<const unsigned char*>(e);

  // one stage: 128 rows x 128 bytes of depth, zero past the rows and past D
  auto load_stage = [&](int step) {
    const int tile = step / nch, ch = step - tile * nch;
    const int t0 = row_begin + tile * kTileN;
    unsigned char* st = ring + (step % NS) * kStageB;
#pragma unroll
    for (int i = 0; i < kLoadsPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, u = c & 7;
      const int row = t0 + r, byte = ch * kChunkB + u * 16;
      unsigned char* dst = st + r * kChunkB + ((u ^ (r & 7)) << 4);
      const bool ok = row < row_end && byte < RB;
      const unsigned char* src = eb + static_cast<size_t>(row) * RB + byte;
      if (vec) {
        tc::cp_async16(dst, ok ? src : eb, ok ? 16 : 0);
      } else {
        for (int x = 0; x < 16; ++x) dst[x] = ok && byte + x < RB ? src[x] : 0;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nsteps) load_stage(s);
    tc::cp_async_commit();
  }

  // queries (already in the corpus type) into shared memory, zero past D
  // and past B; empty k-lists and candidate buffers
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(q);
  for (int x = tid; x < QB * (QSB / 4); x += kThreads) {
    const int qi = x / (QSB / 4), byte = (x - qi * (QSB / 4)) * 4;
    uint32_t w = 0u;
    if (q0 + qi < B)
      for (int y = 0; y < 4 && byte + y < RB; ++y)
        w |= static_cast<uint32_t>(qb[static_cast<size_t>(q0 + qi) * RB + byte + y]) << (8 * y);
    *reinterpret_cast<uint32_t*>(qs + qi * QSB + byte) = w;
  }
  for (int x = tid; x < QB * k; x += kThreads) { lv[x] = -INFINITY; li[x] = INT_MAX; }
  for (int x = tid; x < QB; x += kThreads) cnt[x] = 0;

  Acc acc[NT][4];
  float br[PER_QUERY ? NT : 1][4];
  for (int step = 0; step < nsteps; ++step) {
    tc::cp_async_wait<NS - 2>();
    __syncthreads();  // stage `step` is in; stage step - 1 is no longer read
    if (step + NS - 1 < nsteps) load_stage(step + NS - 1);
    tc::cp_async_commit();

    const int tile = step / nch, ch = step - tile * nch;
    const int t0 = row_begin + tile * kTileN;
    const int r0 = t0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0;
      // the tile's bias, in flight during the products
#pragma unroll
      for (int n = 0; n < (PER_QUERY ? NT : 1); ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + (c >> 1) * 8;
          const int qg = q0 + n * 8 + 2 * t + (c & 1);
          const bool ok = row < row_end && (!PER_QUERY || qg < B);
          br[n][c] = ok ? bias[(PER_QUERY ? static_cast<size_t>(qg) * bias_stride : 0) + row]
                        : 0.f;
        }
    }

    const unsigned char* st = ring + (step % NS) * kStageB;
    const int ar = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kp = 0; kp < kChunkB / 32; kp += 2) {  // two 32-byte k-steps
      uint32_t a[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = (kp + j) * 2 + (lane >> 4);
        tc::ldmatrix_x4(a[j], st + ar * kChunkB + ((u ^ (ar & 7)) << 4));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, qs + (n * 8 + (lane & 7)) * QSB + ch * kChunkB + kp * 32 +
                               (lane >> 3) * 16);
        if constexpr (kInt8) {
          tc::mma_s8(acc[n], a[0], b[0], b[1]);
          tc::mma_s8(acc[n], a[1], b[2], b[3]);
        } else {
          tc::mma_bf16(acc[n], a[0], b[0], b[1]);
          tc::mma_bf16(acc[n], a[1], b[2], b[3]);
        }
      }
    }
    if (ch != nch - 1) continue;

    // epilogue: scores that beat their query's k-th entry become candidates
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // the k-th scores of this thread's two queries (2t, 2t + 1)
      const int qa = n * 8 + 2 * t;
      const float thr[2] = {lv[qa * k + k - 1], lv[(qa + 1) * k + k - 1]};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + (c >> 1) * 8;
        const int qi = qa + (c & 1);
        if (row >= row_end || q0 + qi >= B) continue;
        // the product rounds before the bias is added (no FMA), as in the
        // plain version and the TPU kernel
        const float v = __fmul_rn(static_cast<float>(acc[n][c]), scale) +
                        br[PER_QUERY ? n : 0][c];
        if (v > thr[c & 1] || (v == thr[c & 1] && row < li[qi * k + k - 1])) {
          const int p = atomicAdd(&cnt[qi], 1);
          cv[qi * kTileN + p] = v;
          ci[qi * kTileN + p] = row;
        }
      }
    }
    __syncthreads();
    // each warp merges the candidates of its queries into their k-lists
    for (int qi = warp; qi < QB; qi += kWarps) {
      const int n = cnt[qi];
      if (n == 0) continue;
      if (k <= 32) {
        merge_small(lv + qi * k, li + qi * k, k, cv + qi * kTileN, ci + qi * kTileN, n);
      } else {
        float thr_v = lv[qi * k + k - 1];
        int thr_i = li[qi * k + k - 1];
        for (int base = 0; base < n; base += 32) {
          const int x = base + lane;
          const bool valid = x < n;
          warp_offer(lv + qi * k, li + qi * k, k, valid ? cv[qi * kTileN + x] : -INFINITY,
                     valid ? ci[qi * kTileN + x] : INT_MAX, valid, thr_v, thr_i);
        }
      }
      if (lane == 0) cnt[qi] = 0;
    }
  }
  __syncthreads();
  for (int x = tid; x < QB * k; x += kThreads) {
    const int qi = x / k, j = x - qi * k;
    const int qg = q0 + qi;
    if (qg < B) {
      const size_t o = (static_cast<size_t>(qg) * splits + split) * k + j;
      part_v[o] = lv[x];
      part_i[o] = li[x];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int splits, int k, int n_pad, int n_active,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = blockIdx.x * kWarps + warp;
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kWarps * k) + warp * k;
  if (qg >= B) return;  // warp-uniform; no block-wide barrier below
  for (int j = lane; j < k; j += 32) { lv[j] = -INFINITY; li[j] = INT_MAX; }
  __syncwarp();
  float thr_v = -INFINITY;
  int thr_i = INT_MAX;
  const size_t n = static_cast<size_t>(splits) * k;
  const float* pv = part_v + static_cast<size_t>(qg) * n;
  const int* pi = part_i + static_cast<size_t>(qg) * n;
  if (k <= 32) {
    merge_small(lv, li, k, pv, pi, static_cast<int>(n));
    thr_v = lv[k - 1];
    thr_i = li[k - 1];
  } else {
    for (size_t base = 0; base < n; base += 32) {
      const size_t x = base + lane;
      const bool valid = x < n;
      const float v = valid ? pv[x] : -INFINITY;
      const int r = valid ? pi[x] : INT_MAX;
      warp_offer(lv, li, k, v, r, valid, thr_v, thr_i);
    }
  }
  // the masked rows: (NEG_INF, n_active + x) for the first k of them
  const int masked = min(k, n_pad - n_active);
  for (int base = 0; base < masked; base += 32) {
    const int x = base + lane;
    warp_offer(lv, li, k, kNegInf, n_active + x, x < masked, thr_v, thr_i);
  }
  for (int j = lane; j < k; j += 32) {
    out_v[static_cast<size_t>(qg) * k + j] = lv[j];
    out_i[static_cast<size_t>(qg) * k + j] = li[j];
  }
}

// The pass-1 kernel of a call, its block of queries and its shared memory.
struct Route {
  const void* fn;
  int qb;
  size_t smem;
};

template <int QB>
Route f32_route(int D, int k) {
  return {reinterpret_cast<const void*>(topk_partial_kernel<QB>), QB,
          partial_smem_bytes(QB, D, k)};
}

template <typename T, int QB, int NS>
Route tc_route(int D, int k, bool per_query) {
  const void* fn =
      per_query ? reinterpret_cast<const void*>(tc_topk_partial_kernel<T, QB, true, NS>)
                : reinterpret_cast<const void*>(tc_topk_partial_kernel<T, QB, false, NS>);
  return {fn, QB, tc_smem_bytes(NS, QB, D, sizeof(T), k)};
}

// The deep ring, unless only the shallow one lets two CTAs share an SM: a
// CTA of 8 warps waits at a barrier every stage, and a second CTA hides
// that better than more stages do (measured on an H100).  The depth is a
// template argument: a depth known only at run time measured slower.
template <typename T, int QB>
Route tc_route(int D, int k, bool per_query, int sm_smem) {
  const auto fits_two = [&](int ns) {
    return 2 * (tc_smem_bytes(ns, QB, D, sizeof(T), k) + 1024) <= static_cast<size_t>(sm_smem);
  };
  if (!fits_two(kDeepRing) && fits_two(kShallowRing))
    return tc_route<T, QB, kShallowRing>(D, k, per_query);
  return tc_route<T, QB, kDeepRing>(D, k, per_query);
}

template <typename T>
Route tc_route(int qb, int D, int k, bool per_query, int sm_smem) {
  return qb == 8 ? tc_route<T, 8>(D, k, per_query, sm_smem)
                 : tc_route<T, 32>(D, k, per_query, sm_smem);
}

// dtype 0: f32 on the CUDA cores, 8 or 32 queries a CTA.  1 (bf16) and 2
// (int8): tensor cores, 8 or 32 queries a CTA (32 unless the batch is 8 or
// less, or D is too large for it).  64 queries a CTA read the corpus half as
// often at B = 256 but let one CTA only on an SM, and measured slower.
cudaError_t pick_route(int dtype, int B, int D, int k, int per_query, Route* r) {
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  int dev = 0, cap = 0, sm_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  if (dtype == 0) {
    *r = B <= 8 ? f32_route<8>(D, k) : f32_route<32>(D, k);
    if (r->smem > static_cast<size_t>(cap)) return cudaErrorInvalidValue;
  } else {
    for (int qb = B <= 8 ? 8 : 32;; qb = 8) {
      *r = dtype == 1 ? tc_route<__nv_bfloat16>(qb, D, k, per_query, sm_smem)
                      : tc_route<int8_t>(qb, D, k, per_query, sm_smem);
      if (r->smem <= static_cast<size_t>(cap)) break;
      if (qb == 8) return cudaErrorInvalidValue;  // D too large for shared memory
    }
  }
  return cudaFuncSetAttribute(r->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(r->smem));
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 (see ops/topk.py).
// The splits cover the live rows [0, n_active): one wave of CTAs over
// (query blocks x splits).
int archi_fused_topk_plan(int dtype, int B, int D, int n_active, int k,
                          int bias_per_query, int* splits, int* rows_per_split) {
  Route r;
  cudaError_t err = pick_route(dtype, B, D, k, bias_per_query, &r);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, r.fn, kThreads,
                                                           r.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int qblocks = (B + r.qb - 1) / r.qb;
  const int tiles = max(1, (n_active + kTileN - 1) / kTileN);
  int s = (per_sm * sms + qblocks - 1) / qblocks;
  s = max(1, min(s, min(tiles, 65535)));
  const int tiles_per_split = (tiles + s - 1) / s;
  *rows_per_split = tiles_per_split * kTileN;
  *splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  return cudaSuccess;
}

int archi_fused_topk(int dtype, const void* q, const void* e, const float* bias,
                     int bias_per_query, int B, int D, int n_pad, int n_active,
                     int k, float scale, int splits, int rows_per_split, int vec,
                     float* part_v, int* part_i, float* out_v, int* out_i,
                     void* stream) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  Route r;
  cudaError_t err = pick_route(dtype, B, D, k, bias_per_query, &r);
  if (err != cudaSuccess) return err;
  int bs = bias_per_query ? n_pad : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // both pass-1 kernels take the same arguments
  void* args[] = {&q, &e, &bias, &bs, &B, &D, &n_active, &k, &rows_per_split,
                  &scale, &vec, &part_v, &part_i};
  err = cudaLaunchKernel(r.fn, dim3((B + r.qb - 1) / r.qb, splits), dim3(kThreads), args,
                         r.smem, st);
  if (err != cudaSuccess) return err;
  const size_t msmem = static_cast<size_t>(kWarps) * k * (sizeof(float) + sizeof(int));
  topk_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, msmem, st>>>(
      part_v, part_i, B, splits, k, n_pad, n_active, out_v, out_i);
  return cudaGetLastError();
}

const char* archi_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
