// BM25 scores of a batch of queries, scattered into dense rows (CUDA C++,
// sm_90a).
//
// Replaces the scatter of the TPU function `_scatter_scores` in
// archi_tpu/engine/bm25.py (a `fori_loop` over a query's work list of
// CHUNK-sized postings pieces, each a dynamic slice, the impact arithmetic
// and `scores.at[rows].add(imps, mode="drop")`).  That function is XLA, not
// Pallas; here it is a kernel because its PyTorch form took about 20 small
// launches and three blocking copies a query (`repeat_interleave`, gathers,
// a zero fill, `index_add_`), so the host spent ~90 ms a micro-batch of 32
// queries launching microseconds of device work.
//
// Input: the postings buffers rows [cap] int32, tf [cap] f32, dl [cap] f32,
// and a work list of W pieces, each an int4 (query q, start, length <= 2048,
// idf as the bits of an f32).  Piece i adds, for j < length,
//
//     denom = tf + k1 * ((1 - b) + b * dl * inv_avgdl)
//     impact = idf * tf * (k1 + 1) / max(denom, 1e-9)
//
// (entry start + j, in this order of f32 operations, each rounded) into
// out[q * n_pad + rows[start + j]] for rows < n_pad; rows >= n_pad are
// dropped, as the TPU function's mode="drop" drops them.  hit[q] becomes 1
// where some posting of query q landed: every impact is positive (idf > 0,
// tf >= 1), so that is the test "the query's best score is above 0".
//
// What bounds it on an H100: the bytes.  A micro-batch of 32 queries reads
// 10^5 - 10^6 postings entries (12 bytes each) and adds 4 bytes into the
// scores for each: at most ~16 MB, ~5 us at 3.35 TB/s; the wrapper's zero
// fill of the [rows, n_pad] f32 output is the rest (64 MB at 32 x 2^19 rows,
// ~20 us).  Arithmetic is ~10 operations an entry.
//
// Design: one CTA of 256 threads a piece, striding over its <= 2048 entries
// with coalesced 4-byte loads of rows, tf and dl (8 loads a thread at most);
// the pieces of one query are independent CTAs and their impacts meet in
// f32 atomicAdd, so the sum of a row over the query's terms is taken in no
// fixed order (a few ulps against the plain version).  The work list is a
// single int4 load a CTA.  The CTA's hit flag is one __syncthreads_or.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bm25_scatter_kernel(const int4* __restrict__ work, const int* __restrict__ rows,
                    const float* __restrict__ tf, const float* __restrict__ dl,
                    float* __restrict__ out, unsigned char* __restrict__ hit,
                    long long n_pad, float k1, float one_minus_b, float b,
                    float k1_plus_1, float inv_avgdl) {
  const int4 w = work[blockIdx.x];
  const int q = w.x;
  const long long start = w.y;
  const int length = w.z;
  const float idf = __int_as_float(w.w);
  float* row_out = out + static_cast<long long>(q) * n_pad;
  int landed = 0;
  for (int j = threadIdx.x; j < length; j += kThreads) {
    const long long e = start + j;
    const int r = rows[e];
    if (r >= 0 && r < n_pad) {
      const float t = tf[e];
      const float d = dl[e];
      // the plain version's order, without contraction into FMAs
      const float norm = __fadd_rn(one_minus_b, __fmul_rn(__fmul_rn(b, d), inv_avgdl));
      const float denom = __fadd_rn(t, __fmul_rn(k1, norm));
      const float impact =
          __fdiv_rn(__fmul_rn(__fmul_rn(idf, t), k1_plus_1), fmaxf(denom, 1e-9f));
      atomicAdd(row_out + r, impact);
      landed = 1;
    }
  }
  if (__syncthreads_or(landed) && threadIdx.x == 0) hit[q] = 1;
}

}  // namespace

extern "C" {

// work [n_work, 4] int32 (q, start, length, idf bits), rows/tf/dl the
// postings buffers, out [*, n_pad] f32 and hit [*] u8 zeroed by the caller.
int archi_bm25_scatter(const void* work, int n_work, const int* rows, const float* tf,
                       const float* dl, float* out, unsigned char* hit, long long n_pad,
                       float k1, float one_minus_b, float b, float k1_plus_1,
                       float inv_avgdl, void* stream) {
  if (n_work <= 0) return 0;
  bm25_scatter_kernel<<<n_work, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(work), rows, tf, dl, out, hit, n_pad, k1, one_minus_b, b,
      k1_plus_1, inv_avgdl);
  return static_cast<int>(cudaGetLastError());
}

const char* archi_bm25_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
