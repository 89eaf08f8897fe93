// K7 `frame_best_sub`: the per-frame tail of the full-inventory ptm and
// semi scorers.  in int32 [N, S] mixture scores (S = n_sen, senone
// order) -> out int16 [N, S]: each score cast to int16, minus (ptm,
// sub = 1) the int16 cast of the frame's minimum int32 score, the
// subtraction wrapping in int16; semi (sub = 0) is the cast alone
// (s2_semi_mgau.c:826-875 subtracts nothing).
//
// Replaces the tail of B7, soundswallower_tpu/ops/senscore_jax.py
// _sen_eval (:301-309): XLA's int32->int16 convert wraps, the best is
// the minimum over real senones taken on the int32 values, and ptm
// subtracts it (ptm_mgau.c:397-400).  In senone order every column is a
// real senone, so the grouped layout's valid mask is all true here.
//
// Bound: memory, 6 bytes per score.  One block per frame: a block-wide
// minimum (warp reductions, then one warp over the warp minima), then
// the row is read again (from L1/L2) and written as int16.
#include "sst_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void frame_best_sub_kernel(const int32_t* __restrict__ in,
                                      int16_t* __restrict__ out, int S,
                                      int sub) {
  __shared__ int32_t wmin[kThreads / 32];
  const int n = blockIdx.x;
  const int32_t* row = in + (size_t)n * S;
  int16_t* orow = out + (size_t)n * S;
  if (!sub) {
    for (int s = threadIdx.x; s < S; s += kThreads) orow[s] = (int16_t)row[s];
    return;
  }
  int32_t m = INT32_MAX;
  for (int s = threadIdx.x; s < S; s += kThreads) m = min(m, row[s]);
  m = __reduce_min_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = m;
  __syncthreads();
  m = INT32_MAX;
  for (int w = 0; w < kThreads / 32; ++w) m = min(m, wmin[w]);
  const int16_t best = (int16_t)m;
  for (int s = threadIdx.x; s < S; s += kThreads)
    orow[s] = (int16_t)((int16_t)row[s] - best);
}

}  // namespace

extern "C" int sst_frame_best_sub(const int32_t* in, int16_t* out, int N,
                                  int S, int sub, cudaStream_t stream) {
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  frame_best_sub_kernel<<<N, kThreads, 0, stream>>>(in, out, S, sub);
  return (int)cudaGetLastError();
}
