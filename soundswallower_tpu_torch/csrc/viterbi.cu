// K4 `viterbi_batch`: the shared-graph batch Viterbi, final-node select
// and backtrace in one persistent kernel.
//
// Replaces the jitted XLA programs B4 and B5 of the JAX package:
// soundswallower_tpu/ops/align_jax.py align_viterbi_batch (with
// make_vit_step_lanes, _eval_3st_lanes, vit_carry0_lanes), the
// final-node select of soundswallower_tpu/aligner.py _vit_full.run and
// align_jax.py backtrace_batch.
//
// Bound: latency of the frame recurrence.  The TPU program ran one scan
// step per frame with the batch in the vector lanes; here one block owns
// one utterance row and loops over all frames itself (no launch per
// frame), with the row's Viterbi state (score/hist [P,3], out_score/
// out_hist [P]) in shared memory and one thread per phone.  Each frame
// reads the row's S = 3P senone scores and writes S int16 tokens; two
// block barriers order the HMM update, the predecessor max and the
// entries.  Rows run in parallel, one block each.
//
// Integer semantics follow the JAX program exactly: state_align_search's
// renormalization, hmm.c's update including the reuse of t2 when the 0->2
// skip is absent, K predecessor slots in edge order with a strict `>`,
// first-max final-node select, and the backtrace's masked lookup, which
// yields -2^30 (int16 0) for a state outside [0, S).  Additions wrap like
// XLA's int32 (unsigned arithmetic).
//
// The carry form `sst_viterbi_chunk` (B9) replaces the single-utterance
// programs of the JAX package: align_jax.py make_vit_step scanned from
// vit_carry0 (align_viterbi, and streaming.py AlignStream's 128-frame
// chunks), with _viterbi_graph's final-node select and align_jax.py
// backtrace when it is asked for a path.  One block runs frames t0 ..
// t0+C-1 of one utterance against absolute astart/aend, from the carry
// (score, hist, out_score, out_hist, best_prev) it is given, and writes
// the carry back.  It shares the frame step with K4 (renormalization,
// hmm_update, best over active phones, token record); the one difference
// is make_vit_step's predecessor choice, jnp.argmax over the K slots:
// the first slot's value is the start, so a slot at or below WORST_SCORE
// can still win, where K4's strict `>` from WORST_SCORE takes none.
// Padded frames (t >= n) renormalize the scores, as the scan does.
#include "viterbi_step.h"

namespace {

using sst::kMissing;
using sst::kWorst;

__global__ void viterbi_kernel(
    const int32_t* __restrict__ sen, const int32_t* __restrict__ n_frames,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    const int32_t* __restrict__ entry, const int32_t* __restrict__ fin, int T,
    int P, int K, int n_fin, int16_t* __restrict__ tok,
    int16_t* __restrict__ path, int32_t* __restrict__ fscore) {
  extern __shared__ int32_t sm[];
  int32_t* score = sm;            // [P, 3]
  int32_t* hist = score + 3 * P;  // [P, 3]
  int32_t* osc = hist + 3 * P;    // [P] out_score
  int32_t* ohi = osc + P;         // [P] out_hist
  int32_t* wmax = ohi + P;        // [32]
  uint8_t* anext = reinterpret_cast<uint8_t*>(wmax + 32);  // [P]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n = n_frames[b];
  const int S = 3 * P;

  for (int p = tid; p < P; p += nthr) {
    score[3 * p] = entry[p];
    score[3 * p + 1] = kWorst;
    score[3 * p + 2] = kWorst;
    hist[3 * p] = hist[3 * p + 1] = hist[3 * p + 2] = -1;
    osc[p] = kWorst;
    ohi[p] = -1;
  }
  int32_t best_prev = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int32_t* sen_t = sen + ((size_t)b * T + t) * S;
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    // -- HMM update (_eval_3st_lanes) --
    for (int p = tid; p < P; p += nthr) {
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      lbest = max(lbest, sst::hmm_update(score + 3 * p, hist + 3 * p, osc + p,
                                         ohi + p, tp + 12 * p, sen_t + 3 * p,
                                         act, renorm, best_prev));
      anext[p] = act && t + 1 <= aend[p];
    }
    // block-wide best over active phones
    const int32_t best = sst::block_max(lbest, wmax);

    // -- phone transitions, entries and token record --
    const int nf = t + 1;
    for (int p = tid; p < P; p += nthr) {
      int32_t es = kWorst, eh = -1;
      bool eok = false;
      for (int k = 0; k < K; ++k) {
        const int src = pred_idx[p * K + k];
        const bool ok = pred_ok[p * K + k] && anext[src];
        const int32_t val = ok ? sst::wadd(osc[src], pred_pen[p * K + k]) : kWorst;
        if (val > es) {  // strict: the first slot wins ties
          es = val;
          eh = ohi[src];
          eok = ok;
        }
      }
      if (!eok) eh = -1;
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      const bool enter = eok && nf >= astart[p] && nf <= aend[p] && valid &&
                         (!act || es > score[3 * p]);
      if (enter) {
        score[3 * p] = es;
        hist[3 * p] = eh;
      }
      int16_t* tk = tok + ((size_t)b * T + t) * S + 3 * p;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          tk[e] = (int16_t)hist[3 * p + e];
          hist[3 * p + e] = 3 * p + e;
        }
      } else {
        tk[0] = tk[1] = tk[2] = -1;
      }
    }
    best_prev = best;
    __syncthreads();
  }

  if (tid == 0) {
    // final-node select: first max over the final nodes
    int fnode = fin[0];
    int32_t fbest = osc[fnode];
    for (int i = 1; i < n_fin; ++i) {
      const int32_t v = osc[fin[i]];
      if (v > fbest) {
        fbest = v;
        fnode = fin[i];
      }
    }
    fscore[b] = osc[fnode];
    // backtrace (backtrace_batch); the tokens are this block's own
    // global writes, visible after the loop's last barrier
    int32_t cur = ohi[fnode];
    for (int t = T - 1; t >= 0; --t) {
      const int32_t cand = (cur >= 0 && cur < S)
          ? (int32_t)tok[((size_t)b * T + t) * S + cur] : kMissing;
      path[(size_t)b * T + t] = (int16_t)(t < n ? cur : -1);
      if (t < n - 1) cur = cand;
    }
  }
}

__global__ void viterbi_chunk_kernel(
    const int32_t* __restrict__ sen, int t0, int n,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    int32_t* c_score, int32_t* c_hist, int32_t* c_osc, int32_t* c_ohi,
    int32_t* c_best, int C, int P, int K, int16_t* __restrict__ tok,
    const int32_t* __restrict__ fin, int n_fin, int32_t* __restrict__ path,
    int32_t* __restrict__ fscore) {
  extern __shared__ int32_t sm[];
  int32_t* score = sm;            // [P, 3]
  int32_t* hist = score + 3 * P;  // [P, 3]
  int32_t* osc = hist + 3 * P;    // [P] out_score
  int32_t* ohi = osc + P;         // [P] out_hist
  int32_t* wmax = ohi + P;        // [32]
  uint8_t* anext = reinterpret_cast<uint8_t*>(wmax + 32);  // [P]
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int S = 3 * P;

  for (int p = tid; p < P; p += nthr) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      score[3 * p + e] = c_score[3 * p + e];
      hist[3 * p + e] = c_hist[3 * p + e];
    }
    osc[p] = c_osc[p];
    ohi[p] = c_ohi[p];
  }
  int32_t best_prev = c_best[0];
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const int t = t0 + c;
    const int32_t* sen_t = sen + (size_t)c * S;
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    for (int p = tid; p < P; p += nthr) {
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      lbest = max(lbest, sst::hmm_update(score + 3 * p, hist + 3 * p, osc + p,
                                         ohi + p, tp + 12 * p, sen_t + 3 * p,
                                         act, renorm, best_prev));
      anext[p] = act && t + 1 <= aend[p];
    }
    const int32_t best = sst::block_max(lbest, wmax);

    const int nf = t + 1;
    for (int p = tid; p < P; p += nthr) {
      // jnp.argmax over the slots: the first maximum, starting at slot 0
      int32_t es = kWorst, eh = -1;
      bool eok = false;
      for (int k = 0; k < K; ++k) {
        const int src = pred_idx[p * K + k];
        const bool ok = pred_ok[p * K + k] && anext[src];
        const int32_t val = ok ? sst::wadd(osc[src], pred_pen[p * K + k]) : kWorst;
        if (k == 0 || val > es) {
          es = val;
          eh = ohi[src];
          eok = ok;
        }
      }
      if (!eok) eh = -1;
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      const bool enter = eok && nf >= astart[p] && nf <= aend[p] &&
                         (!act || es > score[3 * p]);
      if (enter) {
        score[3 * p] = es;
        hist[3 * p] = eh;
      }
      int16_t* tk = tok + (size_t)c * S + 3 * p;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          tk[e] = (int16_t)hist[3 * p + e];
          hist[3 * p + e] = 3 * p + e;
        }
      } else {
        tk[0] = tk[1] = tk[2] = -1;
      }
    }
    best_prev = best;
    __syncthreads();
  }

  for (int p = tid; p < P; p += nthr) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      c_score[3 * p + e] = score[3 * p + e];
      c_hist[3 * p + e] = hist[3 * p + e];
    }
    c_osc[p] = osc[p];
    c_ohi[p] = ohi[p];
  }
  if (tid == 0) c_best[0] = best_prev;
  if (fin != nullptr && tid == 0) {
    // _viterbi_graph: first max over the final nodes
    int fnode = fin[0];
    for (int i = 1; i < n_fin; ++i)
      if (osc[fin[i]] > osc[fnode]) fnode = fin[i];
    fscore[0] = osc[fnode];
    // align_jax.py backtrace (frames counted from t0); the gather wraps a
    // negative state and clamps one past the end, as jnp indexing does
    int32_t cur = ohi[fnode];
    const int nl = n - t0;
    for (int c = C - 1; c >= 0; --c) {
      path[c] = c < nl ? cur : -1;
      if (c < nl - 1) {
        const int at = min(max(cur < 0 ? cur + S : cur, 0), S - 1);
        cur = (int32_t)tok[(size_t)c * S + at];
      }
    }
  }
}

}  // namespace

extern "C" int sst_viterbi_chunk(
    const int32_t* sen, int t0, int n, const int32_t* tp,
    const int32_t* pred_idx, const int32_t* pred_pen, const uint8_t* pred_ok,
    const int32_t* astart, const int32_t* aend, int32_t* score, int32_t* hist,
    int32_t* osc, int32_t* ohi, int32_t* best_prev, int C, int P, int K,
    int16_t* tok, const int32_t* fin, int n_fin, int32_t* path,
    int32_t* fscore, cudaStream_t stream) {
  if (P <= 0 || K <= 0 || (fin != nullptr && n_fin <= 0))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaSuccess;
  const size_t smem = sst::smem_bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = min(1024, (P + 31) / 32 * 32);
  viterbi_chunk_kernel<<<1, threads, smem, stream>>>(
      sen, t0, n, tp, pred_idx, pred_pen, pred_ok, astart, aend, score, hist,
      osc, ohi, best_prev, C, P, K, tok, fin, n_fin, path, fscore);
  return (int)cudaGetLastError();
}

extern "C" int sst_viterbi_smem_bytes(int P) { return (int)sst::smem_bytes(P); }

extern "C" int sst_viterbi_batch(const int32_t* sen, const int32_t* n_frames,
                                 const int32_t* tp, const int32_t* pred_idx,
                                 const int32_t* pred_pen,
                                 const uint8_t* pred_ok, const int32_t* astart,
                                 const int32_t* aend, const int32_t* entry,
                                 const int32_t* fin, int B, int T, int P,
                                 int K, int n_fin, int16_t* tok, int16_t* path,
                                 int32_t* fscore, cudaStream_t stream) {
  if (P <= 0 || K <= 0 || n_fin <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const size_t smem = sst::smem_bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = min(1024, (P + 31) / 32 * 32);
  viterbi_kernel<<<B, threads, smem, stream>>>(
      sen, n_frames, tp, pred_idx, pred_pen, pred_ok, astart, aend, entry, fin,
      T, P, K, n_fin, tok, path, fscore);
  return (int)cudaGetLastError();
}
