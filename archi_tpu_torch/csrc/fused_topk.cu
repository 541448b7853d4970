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
// 2 * B * n_active * D operations:
// under the memory time on the tensor cores up to B of about 300, but this
// first version computes them on the CUDA cores in f32 (67 TFLOP/s, 12 us
// per query at these shapes), which puts the operations above the bytes
// from B of about 20 up.
//
// Design.  The TPU kernel walks the tiles in order on one core and carries
// a running [B, 128] top-k in scratch.  CTAs on Hopper run in parallel and
// in no order, so the scan is two passes:
//   pass 1 (topk_partial_kernel): grid (query block, corpus split); the
//     splits cover the live rows [0, n_active) only, so an index whose
//     capacity is well above its rows (a power of two) costs nothing more.
//     Each CTA keeps QB queries in shared memory as f32, streams its split's rows
//     in 128-row tiles through shared memory in 32-deep chunks (the next
//     chunk is loaded into registers while the current one is used), and
//     each warp holds the dot products of its own queries in registers.
//     The warp then offers its 128 candidate rows to the sorted k-list of
//     each of its queries in shared memory; a ballot against the list's
//     last entry keeps the insertions rare once the list is full.  Query
//     blocks are the fastest grid axis, so the CTAs that read one split run
//     together and share it through L2.
//   pass 2 (topk_merge_kernel): one warp per query merges the splits'
//     lists into the final [B, k], then offers the rows past n_active at
//     NEG_INF.  Only the first k of them (n_active .. n_active + k - 1) can
//     rank, so those k stand for all of them: a list with fewer than k
//     live rows above NEG_INF fills with them, lowest row first, exactly
//     as a sort of the full masked score row would.
// bf16 products are exact in f32, so the scores differ from an f32 product
// of the bf16-rounded operands only by the order of the sum.  int8 rows and
// queries (clip(round(127 x))) are summed as integers held in f32, which is
// exact while D * 127^2 < 2^24 (D <= 1040, checked by the wrapper), then
// scaled by 1/127^2 as the TPU kernel's int32 product is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                 // rows per tile: 32 lanes x 4
constexpr int kRowsPerLane = kTileN / 32;
constexpr int kBK = 32;                     // depth of one shared-memory chunk
constexpr int kEStride = kBK + 4;           // padded row stride (floats)
constexpr int kMaxK = 128;
constexpr float kNegInf = -1.0e30f;         // NEG_INF of the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// 16 consecutive elements at a 16-byte aligned address, as f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = s[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 v = s[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      dst[8 * i + 2 * j] = f.x;
      dst[8 * i + 2 * j + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void load16(const int8_t* src, float* dst) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(c[i]);
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

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t partial_smem_bytes(int qb, int d, int k) {
  return sizeof(float) * (static_cast<size_t>(qb) * round_up(d, kBK) +
                          kTileN * kEStride) +
         static_cast<size_t>(qb) * k * (sizeof(float) + sizeof(int));
}

template <typename T, int QB>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ e,
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
    qs[x] = (q0 + qi < B && d < D) ? to_f32(q[static_cast<size_t>(q0 + qi) * D + d]) : 0.f;
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
      const T* src = e + static_cast<size_t>(row) * D;
#pragma unroll
      for (int c = 0; c < 16; ++c) pre[c] = (col + c < D) ? to_f32(src[col + c]) : 0.f;
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
  for (size_t base = 0; base < n; base += 32) {
    const size_t x = base + lane;
    const bool valid = x < n;
    const float v = valid ? pv[x] : -INFINITY;
    const int r = valid ? pi[x] : INT_MAX;
    warp_offer(lv, li, k, v, r, valid, thr_v, thr_i);
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

template <typename T, int QB>
cudaError_t plan_t(int B, int D, int n_active, int k, int* splits, int* rows_per_split) {
  const size_t smem = partial_smem_bytes(QB, D, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<T, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, topk_partial_kernel<T, QB>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // one wave of CTAs over (query blocks x splits of the live rows)
  const int qblocks = (B + QB - 1) / QB;
  const int tiles = max(1, (n_active + kTileN - 1) / kTileN);
  int s = (per_sm * sms + qblocks - 1) / qblocks;
  s = max(1, min(s, min(tiles, 65535)));
  const int tiles_per_split = (tiles + s - 1) / s;
  *rows_per_split = tiles_per_split * kTileN;
  *splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  return cudaSuccess;
}

template <typename T, int QB>
cudaError_t launch_t(const void* q, const void* e, const float* bias,
                     int bias_stride, int B, int D, int n_pad, int n_active,
                     int k, float scale, int splits, int rows_per_split,
                     int vec, float* part_v, int* part_i, float* out_v,
                     int* out_i, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(QB, D, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<T, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((B + QB - 1) / QB, splits);
  topk_partial_kernel<T, QB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), bias, bias_stride, B,
      D, n_active, k, rows_per_split, scale, vec, part_v, part_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t msmem = static_cast<size_t>(kWarps) * k * (sizeof(float) + sizeof(int));
  topk_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, msmem, stream>>>(
      part_v, part_i, B, splits, k, n_pad, n_active, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 (see ops/topk.py).
// The splits cover the live rows [0, n_active).
int archi_fused_topk_plan(int dtype, int B, int D, int n_active, int k,
                          int* splits, int* rows_per_split) {
  const bool small = B <= 8;
#define ARCHI_PLAN_ARGS B, D, n_active, k, splits, rows_per_split
  switch (dtype) {
    case 0: return small ? plan_t<float, 8>(ARCHI_PLAN_ARGS)
                         : plan_t<float, 32>(ARCHI_PLAN_ARGS);
    case 1: return small ? plan_t<__nv_bfloat16, 8>(ARCHI_PLAN_ARGS)
                         : plan_t<__nv_bfloat16, 32>(ARCHI_PLAN_ARGS);
    case 2: return small ? plan_t<int8_t, 8>(ARCHI_PLAN_ARGS)
                         : plan_t<int8_t, 32>(ARCHI_PLAN_ARGS);
  }
#undef ARCHI_PLAN_ARGS
  return cudaErrorInvalidValue;
}

int archi_fused_topk(int dtype, const void* q, const void* e, const float* bias,
                     int bias_per_query, int B, int D, int n_pad, int n_active,
                     int k, float scale, int splits, int rows_per_split, int vec,
                     float* part_v, int* part_i, float* out_v, int* out_i,
                     void* stream) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  const int bs = bias_per_query ? n_pad : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = B <= 8;
#define ARCHI_TOPK_ARGS q, e, bias, bs, B, D, n_pad, n_active, k, scale, splits, \
                        rows_per_split, vec, part_v, part_i, out_v, out_i, st
  switch (dtype) {
    case 0: return small ? launch_t<float, 8>(ARCHI_TOPK_ARGS)
                         : launch_t<float, 32>(ARCHI_TOPK_ARGS);
    case 1: return small ? launch_t<__nv_bfloat16, 8>(ARCHI_TOPK_ARGS)
                         : launch_t<__nv_bfloat16, 32>(ARCHI_TOPK_ARGS);
    case 2: return small ? launch_t<int8_t, 8>(ARCHI_TOPK_ARGS)
                         : launch_t<int8_t, 32>(ARCHI_TOPK_ARGS);
  }
#undef ARCHI_TOPK_ARGS
  return cudaErrorInvalidValue;
}

const char* archi_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
