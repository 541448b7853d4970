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
// What bounds it on an H100.  Bytes: each code byte is read once (S * m, or
// S * m / 2 packed) and each score written once (G * S * 4); at the IVF-PQ
// cell probe's shape (G = 1, m = 48, S = 360,448) that is 18.7 MB, 5.6 us at
// 3.35 TB/s.  Shared memory: one table lookup a code and query tile.  A
// warp's 32 random 8-bit codes over a 256-entry bf16 table find about 2.8
// distinct words in the busiest bank, so a lookup costs about 2.8
// wavefronts: 5.8 us at that shape and 1.98 GHz, the floor beside the bytes.
// Random codes defeat any copy of the table, so the floor stays.  A 16-entry
// table (4-bit codes) sits in distinct banks: conflict-free lookups, and at
// the XL tier's shapes (4 MB) the launch and one round trip to memory are
// most of the kernel.
//
// Design:
//  - Sums sized to the query tile: the kernel is a template on the query
//    tile GT in {1, 2, 4, 8} (the wrapper picks it from G); a thread keeps
//    GT x CPT <= 32 f32 sums, so G = 1 holds only its own.
//  - One lookup a code for the whole tile: the shared table is [j][c][g]
//    bf16, the GT queries of a code side by side (a 32-bit word a pair of
//    queries), read as one 2-, 4-, 8- or 16-byte word.
//  - Loads: a lane scores CPT in {8, 4} consecutive columns with one 8- or
//    4-byte load a code row; the wrapper picks the wider where it still
//    gives every SM 8 busy warps (8 bytes at the cell probe's shape, 4 at
//    the XL tier's; 16-byte loads lost at both).  Two batches of 16 or 24
//    code rows sit in registers, one loading while the other is looked
//    up; the loads are volatile with a memory clobber, so the compiler
//    keeps them ahead of the lookups of the batch before instead of
//    sinking them to their use, and whole batches run without a branch a
//    row.
//  - Prologue: each warp issues its first two batches of code loads, then
//    the CTA loads the f32 table (up to eight float4 a thread at once),
//    rounds it and stores it as 8 GT-byte vectors; code loads first measured
//    faster than table loads first.
//  - Grid: CTAs of 16 warps, one an SM (more where the columns fill them
//    and occupancy allows), each converting its table once; warp tiles of
//    32 x CPT columns are dealt round-robin over the CTAs first, so the SMs'
//    work differs by at most one warp tile.
//  - General cases: a row length S that CPT does not divide, or a codes
//    pointer not aligned to CPT, takes the byte route (CPT = 1); G > GT is
//    tiled over blockIdx.y; a table larger than the shared-memory budget is
//    split into runs of subspaces, one launch each, the later launches
//    adding to the scores of the earlier ones, so the sum keeps the order
//    j = 0..m-1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBudget = 200 * 1024;   // GT = 8, m = 48, ksub 256 in one run
constexpr int kMaxSums = 32;              // GT x CPT f32 sums a thread

// the GT bf16 values of one code: one lookup
template <int GT>
struct Entry;
template <>
struct Entry<1> {
  using T = unsigned short;
};
template <>
struct Entry<2> {
  using T = uint32_t;
};
template <>
struct Entry<4> {
  using T = uint2;
};
template <>
struct Entry<8> {
  using T = uint4;
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[g][k] += table entry e (the bf16 value of query g, g-th half word)
template <int GT, int CPT>
__device__ __forceinline__ void add_entry(float (&acc)[GT][CPT], int k,
                                          const typename Entry<GT>::T& e) {
  if constexpr (GT == 1) {
    acc[0][k] += __uint_as_float(static_cast<uint32_t>(e) << 16);
  } else {
    uint32_t w[GT / 2];
    if constexpr (GT == 2) {
      w[0] = e;
    } else if constexpr (GT == 4) {
      w[0] = e.x, w[1] = e.y;
    } else {
      w[0] = e.x, w[1] = e.y, w[2] = e.z, w[3] = e.w;
    }
#pragma unroll
    for (int p = 0; p < GT / 2; ++p) {
      acc[2 * p][k] += __uint_as_float(w[p] << 16);
      acc[2 * p + 1][k] += __uint_as_float(w[p] & 0xffff0000u);
    }
  }
}

// The table of queries [g0, g0 + GT) over subspaces [j0, j0 + mc) in
// shared memory: tab[j * ksub + c] holds bf16(luts[j0 + j, g0 + g, c]) for
// each g, zero for queries past G.  A table row of whole float4s is
// converted in passes of kTabItems items a thread, an item being the four
// codes [c, c + 4) of one subspace: each pass's loads are issued at once
// (load), then its entries written (store) as one 8 GT-byte vector an item.
template <int GT>
constexpr int kTabItems = GT >= 8 ? 1 : 8 / GT;

template <int GT>
struct TablePass {
  float4 v[kTabItems<GT>][GT];
  int dst[kTabItems<GT>];      // entry of the item's first code; -1 past the table
  int j, c;                    // the thread's next item: subspace, first code

  __device__ __forceinline__ void start(int ksub) {
    const int q4 = ksub >> 2;
    j = threadIdx.x / q4;
    c = (threadIdx.x - j * q4) * 4;
  }

  __device__ __forceinline__ void load(const float* __restrict__ luts, int G, int g0,
                                       int ksub, int j0, int mc) {
    const int ng = min(GT, G - g0);
    const int dj = kThreads / (ksub >> 2), dc = kThreads % (ksub >> 2) * 4;
#pragma unroll
    for (int u = 0; u < kTabItems<GT>; ++u) {
      dst[u] = j < mc ? j * ksub + c : -1;
      if (j < mc) {
        const float* src = luts + (static_cast<long long>(j0 + j) * G + g0) * ksub + c;
#pragma unroll
        for (int g = 0; g < GT; ++g)
          v[u][g] = g < ng ? __ldg(reinterpret_cast<const float4*>(src + g * ksub))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      j += dj, c += dc;
      if (c >= ksub) c -= ksub, ++j;
    }
  }

  __device__ __forceinline__ void store(typename Entry<GT>::T* tab) const {
#pragma unroll
    for (int u = 0; u < kTabItems<GT>; ++u) {
      if (dst[u] < 0) break;
      // entry e (code c + e) is half words [e GT, (e + 1) GT) of the item
      const float4* x = v[u];
      uint32_t w[2 * GT];
      if constexpr (GT == 1) {
        w[0] = bf16_pair(x[0].x, x[0].y), w[1] = bf16_pair(x[0].z, x[0].w);
        *reinterpret_cast<uint2*>(tab + dst[u]) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int p = 0; p < GT / 2; ++p) {
          w[p] = bf16_pair(x[2 * p].x, x[2 * p + 1].x);
          w[GT / 2 + p] = bf16_pair(x[2 * p].y, x[2 * p + 1].y);
          w[GT + p] = bf16_pair(x[2 * p].z, x[2 * p + 1].z);
          w[3 * GT / 2 + p] = bf16_pair(x[2 * p].w, x[2 * p + 1].w);
        }
        uint4* d = reinterpret_cast<uint4*>(tab + dst[u]);
#pragma unroll
        for (int q = 0; q < GT / 2; ++q)
          d[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      }
    }
  }
};

template <int GT>
__device__ __forceinline__ typename Entry<GT>::T make_entry(const float (&f)[GT]) {
  if constexpr (GT == 1) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  } else if constexpr (GT == 2) {
    return bf16_pair(f[0], f[1]);
  } else if constexpr (GT == 4) {
    return make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]));
  } else {
    return make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                      bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
  }
}

// the same table, one entry a thread at a time (ksub % 4 != 0)
template <int GT>
__device__ void fill_table_scalar(typename Entry<GT>::T* tab,
                                  const float* __restrict__ luts, int G, int g0,
                                  int ksub, int j0, int mc) {
  const int ng = min(GT, G - g0);
  for (int i = threadIdx.x; i < mc * ksub; i += blockDim.x) {
    const int j = i / ksub;
    const int c = i - j * ksub;
    float f[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g)
      f[g] = g < ng ? luts[(static_cast<long long>(j0 + j) * G + g0 + g) * ksub + c]
                    : 0.f;
    tab[i] = make_entry<GT>(f);
  }
}

// 32-bit words a lane loads a code row, and code rows a batch
template <int CPT>
constexpr int kWords = CPT >= 4 ? CPT / 4 : 1;
template <int CPT>
constexpr int kRows = CPT == 8 ? 16 : 24;

// Rows [r0, r0 + kRows) of the lane's columns [s, s + CPT); FULL: all of
// them are below n_rows.  Read once: not kept in L1.  The "memory" clobber
// keeps each load where the program puts it, ahead of the lookups of the
// batch before it.
template <int CPT, bool FULL>
__device__ __forceinline__ void load_rows(uint32_t (&w)[kRows<CPT>][kWords<CPT>],
                                          const uint8_t* col, long long S, int r0,
                                          int n_rows) {
#pragma unroll
  for (int u = 0; u < kRows<CPT>; ++u) {
    if (!FULL && r0 + u >= n_rows) break;
    const uint8_t* p = col + static_cast<long long>(r0 + u) * S;
    if constexpr (CPT == 8) {
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                   : "=r"(w[u][0]), "=r"(w[u][1]) : "l"(p) : "memory");
    } else if constexpr (CPT == 4) {
      asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                   : "=r"(w[u][0]) : "l"(p) : "memory");
    } else {
      unsigned short x;
      asm volatile("ld.global.nc.L1::no_allocate.u8 %0, [%1];"
                   : "=h"(x) : "l"(p) : "memory");
      w[u][0] = x;
    }
  }
}

template <int CPT>
__device__ __forceinline__ void load_batch(uint32_t (&w)[kRows<CPT>][kWords<CPT>],
                                           const uint8_t* col, long long S, int r0,
                                           int n_rows) {
  if (r0 + kRows<CPT> <= n_rows)
    load_rows<CPT, true>(w, col, S, r0, n_rows);
  else if (r0 < n_rows)
    load_rows<CPT, false>(w, col, S, r0, n_rows);
}

// The table lookups of rows [r0, r0 + kRows); FULL as for load_rows.  Code
// byte k of a row is column k.
template <bool PACKED, int GT, int CPT, bool FULL>
__device__ __forceinline__ void add_rows(float (&acc)[GT][CPT],
                                         const uint32_t (&w)[kRows<CPT>][kWords<CPT>],
                                         const typename Entry<GT>::T* tab, int ksub,
                                         int r0, int n_rows) {
#pragma unroll
  for (int u = 0; u < kRows<CPT>; ++u) {
    if (!FULL && r0 + u >= n_rows) break;
    const int r = r0 + u;
    const typename Entry<GT>::T* row = tab + (PACKED ? 32 * r : r * ksub);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const uint32_t byte = __byte_perm(w[u][k / 4], 0, 0x4440 + k % 4);
      if constexpr (PACKED) {
        // subspace 2r (low nibble), then 2r + 1 (high nibble)
        add_entry<GT, CPT>(acc, k, row[byte & 15u]);
        add_entry<GT, CPT>(acc, k, row[16 + (byte >> 4)]);
      } else {
        add_entry<GT, CPT>(acc, k, row[byte]);
      }
    }
  }
}

template <bool PACKED, int GT, int CPT>
__device__ __forceinline__ void add_batch(float (&acc)[GT][CPT],
                                          const uint32_t (&w)[kRows<CPT>][kWords<CPT>],
                                          const typename Entry<GT>::T* tab, int ksub,
                                          int r0, int n_rows) {
  if (r0 + kRows<CPT> <= n_rows)
    add_rows<PACKED, GT, CPT, true>(acc, w, tab, ksub, r0, n_rows);
  else if (r0 < n_rows)
    add_rows<PACKED, GT, CPT, false>(acc, w, tab, ksub, r0, n_rows);
}

// Scores of queries [g0, g0 + GT) over subspaces [j0, j0 + mc).  PACKED:
// codes are nibbles, two subspaces a byte (ksub 16).  CPT: columns a lane
// (CPT > 1 needs S % CPT == 0 and a CPT-aligned codes pointer).
template <bool PACKED, int GT, int CPT>
__global__ void __launch_bounds__(kThreads)
adc_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
           float* __restrict__ out, int G, int ksub, long long S, int j0, int mc,
           int accumulate) {
  using E = typename Entry<GT>::T;
  constexpr int kR = kRows<CPT>;
  extern __shared__ uint4 smem[];
  E* tab = reinterpret_cast<E*>(smem);
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, G - g0);
  const int n_rows = PACKED ? mc / 2 : mc;
  const uint8_t* base = codes + static_cast<long long>(PACKED ? j0 / 2 : j0) * S;
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (S + 32 * CPT - 1) / (32 * CPT);
  const long long tile_stride = static_cast<long long>(gridDim.x) * kWarps;
  // warp tiles dealt round-robin over the CTAs first
  long long t = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  long long s = (t * 32 + lane) * CPT;

  // The first two batches of code rows, then the table's first loads, are
  // in flight before the table is converted.
  uint32_t a[kR][kWords<CPT>], b[kR][kWords<CPT>];
  if (t < n_tiles && s < S) {
    load_batch<CPT>(a, base + s, S, 0, n_rows);
    load_batch<CPT>(b, base + s, S, kR, n_rows);
  }
  const bool quads = (ksub & 3) == 0;
  if (quads) {
    TablePass<GT> pass;
    pass.start(ksub);
    pass.load(luts, G, g0, ksub, j0, mc);
    pass.store(tab);
    while (__syncthreads_or(pass.j < mc)) {
      pass.load(luts, G, g0, ksub, j0, mc);
      pass.store(tab);
    }
  } else {
    fill_table_scalar<GT>(tab, luts, G, g0, ksub, j0, mc);
    __syncthreads();
  }

  for (; t < n_tiles; t += tile_stride, s += tile_stride * 32 * CPT) {
    if (s >= S) continue;      // S % CPT == 0: a lane's columns are all in or out
    const uint8_t* col = base + s;
    float acc[GT][CPT];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        acc[g][k] = (accumulate && g < ng) ? out[(g0 + g) * S + s + k] : 0.0f;
    // one batch in flight while the other is looked up
    for (int r0 = 0; r0 < n_rows; r0 += 2 * kR) {
      add_batch<PACKED, GT, CPT>(acc, a, tab, ksub, r0, n_rows);
      load_batch<CPT>(a, col, S, r0 + 2 * kR, n_rows);
      add_batch<PACKED, GT, CPT>(acc, b, tab, ksub, r0 + kR, n_rows);
      load_batch<CPT>(b, col, S, r0 + 3 * kR, n_rows);
    }
    // the next tile's first rows load while this one's scores are stored
    const long long s_next = s + tile_stride * 32 * CPT;
    if (s_next < S) {
      load_batch<CPT>(a, base + s_next, S, 0, n_rows);
      load_batch<CPT>(b, base + s_next, S, kR, n_rows);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) break;
      float* dst = out + (g0 + g) * S + s;
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int k = 0; k < CPT; k += 4)
          *reinterpret_cast<float4*>(dst + k) =
              make_float4(acc[g][k], acc[g][k + 1], acc[g][k + 2], acc[g][k + 3]);
      } else {
        dst[0] = acc[g][0];
      }
    }
  }
}

template <bool PACKED, int GT, int CPT>
int launch_t(const float* luts, const uint8_t* codes, float* out, int m, int G,
             int ksub, long long S, cudaStream_t stream) {
  auto kernel = adc_kernel<PACKED, GT, CPT>;
  // subspaces a launch: the whole table when GT queries' tables fit
  int mc = kSmemBudget / (GT * ksub * 2);
  if (PACKED) mc -= mc % 2;
  if (mc < (PACKED ? 2 : 1)) return cudaErrorInvalidValue;
  if (mc > m) mc = m;
  const size_t smem = static_cast<size_t>(GT) * mc * ksub * 2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long gy = (G + GT - 1) / GT;
  if (gy > 65535) return cudaErrorInvalidValue;
  // CTAs an SM: as many as its share of the warp tiles fills, up to occupancy
  const long long n_tiles = (S + 32 * CPT - 1) / (32 * CPT);
  const long long per_sm = (n_tiles * gy + sms - 1) / sms;
  long long k = (per_sm + kWarps - 1) / kWarps;
  if (k > occ) k = occ;
  long long gx = (static_cast<long long>(sms) * k + gy - 1) / gy;
  if (gx > n_tiles) gx = n_tiles;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  for (int j0 = 0; j0 < m; j0 += mc) {
    const int run = (m - j0) < mc ? (m - j0) : mc;
    kernel<<<grid, kThreads, static_cast<size_t>(GT) * run * ksub * 2, stream>>>(
        luts, codes, out, G, ksub, S, j0, run, j0 > 0 ? 1 : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool PACKED, int GT>
int launch_gt(const float* luts, const uint8_t* codes, float* out, int m, int G,
              int ksub, long long S, int cpt, cudaStream_t stream) {
  switch (cpt) {
    case 8:
      if constexpr (GT * 8 <= kMaxSums)
        return launch_t<PACKED, GT, 8>(luts, codes, out, m, G, ksub, S, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch_t<PACKED, GT, 4>(luts, codes, out, m, G, ksub, S, stream);
    case 1:
      return launch_t<PACKED, GT, 1>(luts, codes, out, m, G, ksub, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool PACKED>
int launch(const float* luts, const uint8_t* codes, float* out, int m, int G,
           int ksub, long long S, int gt, int cpt, cudaStream_t stream) {
  if (m < 1 || G < 1 || S < 1 || ksub < 1 || ksub > 256) return cudaErrorInvalidValue;
  if (PACKED && (ksub != 16 || m % 2)) return cudaErrorInvalidValue;
  if ((ksub & 3) == 0 && reinterpret_cast<uintptr_t>(luts) % 16)
    return cudaErrorMisalignedAddress;
  if (cpt > 1 && (S % cpt || reinterpret_cast<uintptr_t>(codes) % cpt))
    return cudaErrorMisalignedAddress;
  switch (gt) {
    case 1:
      return launch_gt<PACKED, 1>(luts, codes, out, m, G, ksub, S, cpt, stream);
    case 2:
      return launch_gt<PACKED, 2>(luts, codes, out, m, G, ksub, S, cpt, stream);
    case 4:
      return launch_gt<PACKED, 4>(luts, codes, out, m, G, ksub, S, cpt, stream);
    case 8:
      return launch_gt<PACKED, 8>(luts, codes, out, m, G, ksub, S, cpt, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// luts [m, G, ksub] f32 (16-byte aligned when ksub % 4 == 0),
// codes_t [m, S] u8 -> out [G, S] f32.  gt: query tile (1, 2, 4, 8);
// cpt: columns a lane (8, 4: S % cpt == 0 and codes_t cpt-aligned; 1).
int archi_adc_scores(const float* luts, const uint8_t* codes_t, float* out, int m,
                     int G, int ksub, long long S, int gt, int cpt, void* stream) {
  return launch<false>(luts, codes_t, out, m, G, ksub, S, gt, cpt,
                       static_cast<cudaStream_t>(stream));
}

// luts [m, G, 16] f32 (16-byte aligned), packed_t [m/2, S] u8 -> out [G, S] f32.
int archi_adc_scores_lut16(const float* luts, const uint8_t* packed_t, float* out,
                           int m, int G, long long S, int gt, int cpt, void* stream) {
  return launch<true>(luts, packed_t, out, m, G, 16, S, gt, cpt,
                      static_cast<cudaStream_t>(stream));
}

const char* archi_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
