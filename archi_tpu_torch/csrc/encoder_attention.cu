// Bidirectional encoder self-attention (CUDA C++, sm_90a).
//
// Replaces the TPU kernel `encoder_attention` in
// archi_tpu/ops/pallas_attention.py (body `_attention_kernel`).  Per
// (batch, head) it computes softmax(q k^T * sm_scale + key_bias) v with the
// softmax exact over the full row (S <= 512, the encoder's largest sequence
// bucket), in the exp2 domain with log2(e) folded into the scale, f32
// accumulation and the normalisation applied last.  key_bias [B, S] is 0 for
// real tokens and -1e9 for padding; a query row whose keys are all padding
// stays finite (a uniform softmax over the padded keys).
//
// Layout.  The TPU kernel takes [B, nh, hd, S] (sequence on the lanes).
// This kernel reads q, k and v as [B, S, nh, hd] through a row stride, so it
// takes the projection output [B, S, 3H] (or [B, S, H]) of the encoder layer
// as it is, with no transpose, and writes the context as a contiguous
// [B, S, nh, hd] = [B, S, H], which the output projection reads directly.
//
// What bounds it on an H100: at MiniLM-L6's shapes (B = 256, nh = 12,
// hd = 32, S = 128, bf16) the kernel must read q, k, v and write the
// context, 4 * B * S * H * 2 bytes = 101 MB, 0.03 ms at 3.35 TB/s; the
// 4 * B * nh * S^2 * hd = 6.4 GFLOP of the two products take 0.007 ms on
// the bf16 tensor cores.  The bytes grow with S and the operations with
// S^2, so the bound is the bytes up to S of about 600, past the largest
// bucket (512).  On the CUDA cores in f32 (67 TFLOP/s) the same products
// take 0.1 ms, three times the bytes.
//
// Two routes, chosen by the input type:
//
// bf16: tc_attention_kernel, on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulators).  One CTA per (head, batch row), one warp
//   per 16 query rows up to 8 warps.
//   K and V of that head (S <= 512 rows of hd) are copied once into shared
//   memory with cp.async (16 bytes a thread) in rows padded by 16 bytes, so
//   the ldmatrix loads of the fragments hit eight different bank groups;
//   the key bias (times log2 e) sits beside them.  Each warp takes 16 query
//   rows at a time, its q fragments in registers straight from device
//   memory.  Pass 1 computes q k^T on the tensor cores and the exact row
//   max; pass 2 computes q k^T again (the products are cheap: the kernel is
//   bound by bytes), p = exp2(s * scale_log2 + bias - max), the f32 row sum
//   from those p, then rounds p to bf16 as the TPU kernel does
//   (`p.astype(v_t.dtype)`) and multiplies it by V (ldmatrix.trans) into
//   f32 accumulators; the context is scaled by 1/sum last.  hd = 8 pads the
//   depth of q k^T to 16 with zeros (exact).  Keys past S are -inf, so they
//   take no part; padding keys keep -1e9 log2 e and a fully masked row
//   stays finite.  Everything is read from device memory once (q, k, v and
//   the bias) and written once (the context).
//
// f32: attention_kernel, on the CUDA cores in f32: TF32 would not hold the
//   2e-5 agreement with the reference.  One CTA per (query block of 128
//   rows, head, batch); one thread per query row, holding its q row and its
//   f32 context in registers.  The keys stream through shared memory in
//   chunks of 64 (K, V and the bias) and every thread reads each key row as
//   a broadcast.  The same two passes; p stays f32 (rounding to the input
//   type is the identity there).
//
// In both routes the logits are rounded as the plain version rounds them
// (scale product, then bias add: no FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "tc.cuh"

namespace {

constexpr int kQT = 128;  // query rows per CTA (one per thread)
constexpr int kKC = 64;   // keys per shared-memory chunk
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__device__ __forceinline__ float dot_row(const float (&qr)[HD], const float* kr) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
    s = fmaf(qr[d], kv.x, s);
    s = fmaf(qr[d + 1], kv.y, s);
    s = fmaf(qr[d + 2], kv.z, s);
    s = fmaf(qr[d + 3], kv.w, s);
  }
  return s;
}

// Loads keys [c0, c0 + n) of head h into ks (and vs when given) and the
// log2e-scaled key bias into bs; rows past n are zero.
template <int HD>
__device__ __forceinline__ void load_keys(const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ kb,
                                          size_t base, int in_stride, int c0,
                                          int n, float* ks, float* vs,
                                          float* bs) {
  for (int x = threadIdx.x; x < kKC * HD; x += kQT) {
    const int j = x / HD, d = x - j * HD;
    const size_t off = base + static_cast<size_t>(c0 + j) * in_stride + d;
    const bool ok = j < n;
    ks[x] = ok ? k[off] : 0.f;
    if (vs != nullptr) vs[x] = ok ? v[off] : 0.f;
  }
  for (int j = threadIdx.x; j < kKC; j += kQT) bs[j] = j < n ? __fmul_rn(kb[c0 + j], kLog2e) : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(kQT)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int in_stride,
                 const float* __restrict__ key_bias, float* __restrict__ out,
                 int S, int nh, float scale_log2) {
  __shared__ __align__(16) float ks[kKC * HD];
  __shared__ __align__(16) float vs[kKC * HD];
  __shared__ float bs[kKC];

  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kQT + threadIdx.x;
  const bool active = row < S;
  // element offset of (b, s = 0, head h) in q, k and v
  const size_t base = static_cast<size_t>(b) * S * in_stride + static_cast<size_t>(h) * HD;
  const float* kb = key_bias + static_cast<size_t>(b) * S;

  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d)
    qr[d] = active ? q[base + static_cast<size_t>(row) * in_stride + d] : 0.f;

  // pass 1: the row max of the logits
  float m = -INFINITY;
  for (int c0 = 0; c0 < S; c0 += kKC) {
    const int n = min(kKC, S - c0);
    __syncthreads();  // the previous chunk is no longer read
    load_keys<HD>(k, v, kb, base, in_stride, c0, n, ks, nullptr, bs);
    __syncthreads();
    for (int j = 0; j < n; ++j)
      m = fmaxf(m, __fmul_rn(dot_row<HD>(qr, ks + j * HD), scale_log2) + bs[j]);
  }

  // pass 2: exp2, row sum and the unnormalised context
  float l = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int c0 = 0; c0 < S; c0 += kKC) {
    const int n = min(kKC, S - c0);
    __syncthreads();
    load_keys<HD>(k, v, kb, base, in_stride, c0, n, ks, vs, bs);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float p =
          exp2f(__fmul_rn(dot_row<HD>(qr, ks + j * HD), scale_log2) + bs[j] - m);
      l += p;
      const float* vr = vs + j * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }

  if (active) {
    const float inv = 1.0f / l;
    float* dst = out + (static_cast<size_t>(b) * S + row) * nh * HD + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------- bf16
constexpr int kTcMaxWarps = 8;  // warps a CTA: one per 16 query rows, at most 8

__host__ __device__ constexpr int tc_depth(int hd) { return hd < 16 ? 16 : hd; }
// shared-memory row of K and V, in elements: the q k^T depth + 16 bytes
__host__ __device__ constexpr int tc_stride(int hd) { return tc_depth(hd) + 8; }

size_t tc_smem_bytes(int hd, int S) {
  const size_t sp = (S + 15) / 16 * 16;
  return sp * (2 * tc_stride(hd) * sizeof(__nv_bfloat16) + sizeof(float));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[1]) << 16);
}

// q k^T of 16 query rows (fragments qa) and keys [n0, n0 + 16): two 16 x 8
// tiles, s[0] keys n0.., s[1] keys n0 + 8..
template <int HD>
__device__ __forceinline__ void qk_tile(const uint32_t (&qa)[tc_depth(HD) / 16][4],
                                        const __nv_bfloat16* ks, int n0, int lane,
                                        float (&s)[2][4]) {
  constexpr int ST = tc_stride(HD);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < tc_depth(HD) / 16; ++kk) {
    uint32_t kb[4];
    tc::ldmatrix_x4(kb, ks + row * ST + kk * 16 + col);
    tc::mma_bf16(s[0], qa[kk], kb[0], kb[1]);
    tc::mma_bf16(s[1], qa[kk], kb[2], kb[3]);
  }
}

// 2^x on the special-function unit, denormal results flushed to zero,
// without exp2f's handling of them: a p below 2^-126 adds nothing to a row
// sum of at least 1 (the max's own p is 1).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
tc_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, int in_stride,
                    const float* __restrict__ key_bias, __nv_bfloat16* __restrict__ out,
                    int S, int nh, float scale_log2, int vec) {
  constexpr int KD = tc_depth(HD);  // depth of q k^T
  constexpr int ST = tc_stride(HD);
  constexpr int CH = HD / 8;        // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = (S + 15) / 16 * 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [sp][ST]
  __nv_bfloat16* vs = ks + sp * ST;                                 // [sp][ST]
  float* bs = reinterpret_cast<float*>(vs + sp * ST);               // [sp]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const size_t base = static_cast<size_t>(b) * S * in_stride + static_cast<size_t>(h) * HD;
  const float* kb = key_bias + static_cast<size_t>(b) * S;

  // K and V of this head into shared memory; keys past S are zero
  for (int x = tid; x < sp * CH; x += blockDim.x) {
    const int j = x / CH, c = (x - j * CH) * 8;
    const size_t off = base + static_cast<size_t>(j) * in_stride + c;
    if (vec) {
      const int n = j < S ? 16 : 0;
      tc::cp_async16(ks + j * ST + c, n ? k + off : k, n);
      tc::cp_async16(vs + j * ST + c, n ? v + off : v, n);
    } else {
      const uint16_t* ku = reinterpret_cast<const uint16_t*>(k);
      const uint16_t* vu = reinterpret_cast<const uint16_t*>(v);
      uint16_t* kd = reinterpret_cast<uint16_t*>(ks + j * ST + c);
      uint16_t* vd = reinterpret_cast<uint16_t*>(vs + j * ST + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kd[e] = j < S ? ku[off + e] : 0;
        vd[e] = j < S ? vu[off + e] : 0;
      }
    }
  }
  tc::cp_async_commit();
  if (KD > HD)  // hd = 8: the depth of q k^T is padded to 16 with zeros
    for (int j = tid; j < sp; j += blockDim.x)
      *reinterpret_cast<uint4*>(ks + j * ST + HD) = make_uint4(0, 0, 0, 0);
  for (int j = tid; j < sp; j += blockDim.x)
    bs[j] = j < S ? __fmul_rn(kb[j], kLog2e) : -INFINITY;

  const int g = lane >> 2, t = lane & 3;
  const int nq_tiles = (S + 15) / 16;
  uint32_t qa[KD / 16][4];
  auto load_q = [&](int m0) {
    const int r0 = m0 + g, r1 = m0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r1 : r0;
        const int c = kk * 16 + (i >> 1) * 8 + 2 * t;
        qa[kk][i] = (r < S && c < HD)
                        ? ld_pair(q + base + static_cast<size_t>(r) * in_stride + c, vec)
                        : 0u;
      }
  };
  if (warp < nq_tiles) load_q(warp * 16);  // in flight with the copies
  tc::cp_async_wait<0>();
  __syncthreads();

  for (int tile = warp; tile < nq_tiles; tile += warps) {
    const int m0 = tile * 16;
    if (tile != warp) load_q(m0);

    // pass 1: the exact row max (rows g and g + 8 of the tile)
    float mx[2] = {-INFINITY, -INFINITY};
    for (int n0 = 0; n0 < sp; n0 += 16) {
      float s[2][4];
      qk_tile<HD>(qa, ks, n0, lane, s);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = n0 + i * 8 + 2 * t;
        const float b0 = bs[c], b1 = bs[c + 1];
        mx[0] = fmaxf(mx[0], fmaxf(__fmul_rn(s[i][0], scale_log2) + b0,
                                   __fmul_rn(s[i][1], scale_log2) + b1));
        mx[1] = fmaxf(mx[1], fmaxf(__fmul_rn(s[i][2], scale_log2) + b0,
                                   __fmul_rn(s[i][3], scale_log2) + b1));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // pass 2: p, the f32 row sum, and p (as bf16) times V
    float l[2] = {0.f, 0.f};
    float acc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    for (int n0 = 0; n0 < sp; n0 += 16) {
      float s[2][4];
      qk_tile<HD>(qa, ks, n0, lane, s);
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = n0 + i * 8 + 2 * t;
        const float b0 = bs[c], b1 = bs[c + 1];
        const float p0 = ex2_ftz(__fmul_rn(s[i][0], scale_log2) + b0 - mx[0]);
        const float p1 = ex2_ftz(__fmul_rn(s[i][1], scale_log2) + b1 - mx[0]);
        const float p2 = ex2_ftz(__fmul_rn(s[i][2], scale_log2) + b0 - mx[1]);
        const float p3 = ex2_ftz(__fmul_rn(s[i][3], scale_log2) + b1 - mx[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * i] = tc::pack_bf16(p0, p1);      // row g, keys c, c + 1
        pa[2 * i + 1] = tc::pack_bf16(p2, p3);  // row g + 8
      }
      const __nv_bfloat16* vr = vs + (n0 + vrow) * ST;
      if constexpr (HD == 8) {
        uint32_t vb[2];
        tc::ldmatrix_x2_trans(vb, vr);
        tc::mma_bf16(acc[0], pa, vb[0], vb[1]);
      } else {
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += 16) {
          uint32_t vb[4];
          tc::ldmatrix_x4_trans(vb, vr + d0 + (lane >> 4) * 8);
          tc::mma_bf16(acc[d0 / 8], pa, vb[0], vb[1]);
          tc::mma_bf16(acc[d0 / 8 + 1], pa, vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row >= S) continue;
      const float inv = 1.0f / l[r];
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(b) * S + row) * nh * HD + static_cast<size_t>(h) * HD;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(dst + d * 8 + 2 * t) =
            tc::pack_bf16(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, int in_stride,
                      const float* key_bias, void* out, int B, int S, int nh,
                      float scale_log2, int vec, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(HD, S);
  static size_t opted = 0;  // dynamic shared memory granted so far
  if (smem > opted) {
    int dev = 0, cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > static_cast<size_t>(cap)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(tc_attention_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return err;
    opted = cap;
  }
  const int warps = min(kTcMaxWarps, (S + 15) / 16);
  tc_attention_kernel<HD><<<dim3(nh, B), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), in_stride, key_bias,
      static_cast<__nv_bfloat16*>(out), S, nh, scale_log2, vec);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     int in_stride, const float* key_bias, void* out, int B,
                     int S, int nh, float scale_log2, cudaStream_t stream) {
  dim3 grid((S + kQT - 1) / kQT, nh, B);
  attention_kernel<HD><<<grid, kQT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), in_stride, key_bias, static_cast<float*>(out), S,
      nh, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); see
// ops/attention.py.  q, k and v are [B, S, nh, hd] with `in_stride`
// elements between sequence positions; out is a contiguous [B, S, nh, hd].
// scale_log2 = sm_scale * log2(e).  vec (bf16): q, k and v start on 16
// bytes and in_stride is a multiple of 8, so rows are copied 16 bytes at a
// time.
int archi_encoder_attention(int dtype, const void* q, const void* k,
                            const void* v, int in_stride,
                            const float* key_bias, void* out, int B, int S,
                            int nh, int hd, float scale_log2, int vec,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARCHI_ATTN_ARGS q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2
  if (dtype == 0) {
    switch (hd) {
      case 8: return launch_t<8>(ARCHI_ATTN_ARGS, st);
      case 16: return launch_t<16>(ARCHI_ATTN_ARGS, st);
      case 32: return launch_t<32>(ARCHI_ATTN_ARGS, st);
      case 64: return launch_t<64>(ARCHI_ATTN_ARGS, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 8: return launch_tc<8>(ARCHI_ATTN_ARGS, vec, st);
      case 16: return launch_tc<16>(ARCHI_ATTN_ARGS, vec, st);
      case 32: return launch_tc<32>(ARCHI_ATTN_ARGS, vec, st);
      case 64: return launch_tc<64>(ARCHI_ATTN_ARGS, vec, st);
    }
  }
#undef ARCHI_ATTN_ARGS
  return cudaErrorInvalidValue;
}

const char* archi_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
