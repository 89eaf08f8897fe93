// The per-phone frame step shared by the Viterbi kernels K4
// (viterbi.cu) and K6 (viterbi_rows.cu): XLA's wrapping int32 adds, the
// shared-memory layout of a block's Viterbi state, and hmm.c's 3-state
// update (align_jax.py _eval_3st_lanes) with the renormalization rule.
#pragma once

#include <climits>

#include "sst_kernels.h"

namespace sst {

constexpr int32_t kWorst = SST_WORST_SCORE;
constexpr int32_t kMissing = -(1 << 30);  // backtrace_batch's masked-max floor

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// score, hist [3P] + out_score, out_hist [P] + 32 warp maxima, then
// active_next [P] bytes
__host__ __device__ inline size_t smem_bytes(int P) {
  return (size_t)(8 * P + 32) * sizeof(int32_t) + (size_t)P;
}

// Frame update of phone p: renormalizes its scores when the previous
// frame's best crossed the threshold, and, when the phone is active,
// runs the 3-state update (reading the row's senone scores sen3 [3] and
// the negated tmat tq [3, 4]), writing out_score/out_hist when the exit
// state is reached.  Returns the phone's best new score (kWorst when
// inactive).
__device__ __forceinline__ int32_t hmm_update(
    int32_t* score, int32_t* hist, int32_t* osc, int32_t* ohi,
    const int32_t* __restrict__ tq, const int32_t* __restrict__ sen3,
    bool act, bool renorm, int32_t best_prev) {
  int32_t sc0 = score[0], sc1 = score[1], sc2 = score[2];
  if (renorm) {
    if (sc0 > kWorst) sc0 = wsub(sc0, best_prev);
    if (sc1 > kWorst) sc1 = wsub(sc1, best_prev);
    if (sc2 > kWorst) sc2 = wsub(sc2, best_prev);
  }
  const int32_t h0 = hist[0], h1 = hist[1], h2 = hist[2];
  // tprob(i, j) = -tq[4 * i + j]
  const int32_t s0 = wsub(sc0, sen3[0]);
  const int32_t s1 = wsub(sc1, sen3[1]);
  const int32_t s2 = wsub(sc2, sen3[2]);
  int32_t bst = kWorst;
  // state 3 (non-emitting exit)
  const int32_t x1 = wsub(s2, tq[4 * 2 + 3]);
  const int32_t x2 =
      (-tq[4 * 1 + 3] > SST_TMAT_WORST) ? wsub(s1, tq[4 * 1 + 3]) : INT_MIN;
  if (act && s1 > kWorst) {
    const int32_t s3 = max(x1 > x2 ? x1 : x2, kWorst);
    *osc = s3;
    *ohi = x1 > x2 ? h2 : h1;
    bst = s3;
  }
  // state 2; t2 carries over from state 3 when 0->2 is absent
  const int32_t a0 = wsub(s2, tq[4 * 2 + 2]);
  const int32_t a1 = wsub(s1, tq[4 * 1 + 2]);
  const int32_t a2 =
      (-tq[4 * 0 + 2] > SST_TMAT_WORST) ? wsub(s0, tq[4 * 0 + 2]) : x2;
  const bool br = a0 > a1;
  const bool use2 = br ? a2 > a0 : a2 > a1;
  const int32_t ns2 = max(use2 ? a2 : (br ? a0 : a1), kWorst);
  const int32_t nh2 = use2 ? h0 : (br ? h2 : h1);
  // state 1
  const int32_t b0 = wsub(s1, tq[4 * 1 + 1]);
  const int32_t b1 = wsub(s0, tq[4 * 0 + 1]);
  const int32_t ns1 = max(b0 > b1 ? b0 : b1, kWorst);
  const int32_t nh1 = b0 > b1 ? h1 : h0;
  // state 0
  const int32_t ns0 = max(wsub(s0, tq[0]), kWorst);
  if (act) {
    bst = max(bst, max(ns2, max(ns1, ns0)));
    sc0 = ns0;
    sc1 = ns1;
    sc2 = ns2;
    hist[1] = nh1;
    hist[2] = nh2;
  }
  score[0] = sc0;
  score[1] = sc1;
  score[2] = sc2;
  return bst;
}

// Block-wide max of v, returned to every thread; wmax is 32 ints of
// shared memory that no thread may write again before the next barrier.
__device__ __forceinline__ int32_t block_max(int32_t v, int32_t* wmax) {
  const int tid = threadIdx.x;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = __reduce_max_sync(0xffffffffu, v);
  if ((tid & 31) == 0) wmax[tid >> 5] = v;
  __syncthreads();
  int32_t best = kWorst;
  for (int w = 0; w < nwarps; ++w) best = max(best, wmax[w]);
  return best;
}

}  // namespace sst
