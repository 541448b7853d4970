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
// bucket (512).
// This first version computes on the CUDA cores in f32 and is bound by
// those operations, not by the bytes: making it reach the bytes needs the
// tensor cores (mma / wgmma), work for a later version.
//
// Design.  One CTA per (query block of 128 rows, head, batch); one thread
// per query row, holding its q row and its f32 context in registers.  The
// keys stream through shared memory in chunks of 64 (K, V and the bias,
// converted to f32) and every thread reads each key row as a broadcast.
// Two passes over the keys give the exact full-row softmax of the TPU
// kernel: the first finds the row max, the second sums exp2(s - max) and
// accumulates p * v; the context is scaled by 1/sum last.  Unlike the TPU
// kernel, p is not rounded to the input type before the PV product.  The
// logits are rounded as the plain version rounds them (scale product, then
// bias add: no FMA), so a row's max is the same in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kQT = 128;  // query rows per CTA (one per thread)
constexpr int kKC = 64;   // keys per shared-memory chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T, int HD>
__device__ __forceinline__ void load_keys(const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const float* __restrict__ kb,
                                          size_t base, int in_stride, int c0,
                                          int n, float* ks, float* vs,
                                          float* bs) {
  for (int x = threadIdx.x; x < kKC * HD; x += kQT) {
    const int j = x / HD, d = x - j * HD;
    const size_t off = base + static_cast<size_t>(c0 + j) * in_stride + d;
    const bool ok = j < n;
    ks[x] = ok ? to_f32(k[off]) : 0.f;
    if (vs != nullptr) vs[x] = ok ? to_f32(v[off]) : 0.f;
  }
  for (int j = threadIdx.x; j < kKC; j += kQT) bs[j] = j < n ? __fmul_rn(kb[c0 + j], kLog2e) : 0.f;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kQT)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int in_stride,
                 const float* __restrict__ key_bias, T* __restrict__ out,
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
    qr[d] = active ? to_f32(q[base + static_cast<size_t>(row) * in_stride + d]) : 0.f;

  // pass 1: the row max of the logits
  float m = -INFINITY;
  for (int c0 = 0; c0 < S; c0 += kKC) {
    const int n = min(kKC, S - c0);
    __syncthreads();  // the previous chunk is no longer read
    load_keys<T, HD>(k, v, kb, base, in_stride, c0, n, ks, nullptr, bs);
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
    load_keys<T, HD>(k, v, kb, base, in_stride, c0, n, ks, vs, bs);
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
    T* dst = out + (static_cast<size_t>(b) * S + row) * nh * HD + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     int in_stride, const float* key_bias, void* out, int B,
                     int S, int nh, float scale_log2, cudaStream_t stream) {
  dim3 grid((S + kQT - 1) / kQT, nh, B);
  attention_kernel<T, HD><<<grid, kQT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), in_stride, key_bias, static_cast<T*>(out), S,
      nh, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        int in_stride, const float* key_bias, void* out, int B,
                        int S, int nh, float scale_log2, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch_t<T, 8>(q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, stream);
    case 16: return launch_t<T, 16>(q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, stream);
    case 32: return launch_t<T, 32>(q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, stream);
    case 64: return launch_t<T, 64>(q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (see ops/attention.py).  q, k and v are
// [B, S, nh, hd] with `in_stride` elements between sequence positions; out
// is a contiguous [B, S, nh, hd].  scale_log2 = sm_scale * log2(e).
int archi_encoder_attention(int dtype, const void* q, const void* k,
                            const void* v, int in_stride,
                            const float* key_bias, void* out, int B, int S,
                            int nh, int hd, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, st);
    case 1: return dispatch_hd<__nv_bfloat16>(hd, q, k, v, in_stride, key_bias, out, B, S, nh, scale_log2, st);
  }
  return cudaErrorInvalidValue;
}

const char* archi_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
