// K6 `viterbi_rows`: the per-row-graph batch Viterbi, masked final-node
// select and backtrace (with path scores) in one persistent kernel.
//
// Replaces the jitted XLA programs B4 and B5 in their per-row forms
// (B6's Viterbi) of the JAX package: soundswallower_tpu/ops/align_jax.py
// align_viterbi_batch over stack_graphs tensors (make_vit_step_lanes'
// per-lane K-slot gathers and its banded row shifts), the masked select
// of soundswallower_tpu/aligner.py _vit_full_mg.run, and
// backtrace_batch, with the token-score stack and path scores when
// want_scores is on.
//
// Bound: latency of the frame recurrence, as K4 (viterbi.cu): one block
// owns one row and loops over all frames, its Viterbi state in shared
// memory, one thread per phone.  What differs from K4: every graph table
// is the row's own (tp [B,P,3,4], pred_* [B,P,K], band_* [B,W,P],
// astart/aend/entry/final_mask [B,P]), so a batch of different
// transcripts is one launch.  The TPU program turned the per-lane
// predecessor gathers into W static row shifts (band form) because its
// gathers were slow; on the GPU both forms are shared-memory reads, and
// both are kept because they break ties differently:
//
// * band form: slot i holds the edge p-(W-i) -> p; slots are visited in
//   i order (offset descending, source ascending) with a strict `>`; a
//   source below 0 is absent;
// * K-slot form (no band: an edge offset < 1 or > w_cap): the slots of
//   build_pred_table in edge order, strict `>`.
//
// Final select: first max over node index of the out scores masked by
// final_mask; a row whose best is WORST backtraces from -1, whose
// masked lookup yields -2^30 (int16 0), as the JAX program.
#include "viterbi_step.h"

namespace {

using sst::kMissing;
using sst::kWorst;

template <bool kBand, bool kScores>
__global__ void viterbi_rows_kernel(
    const int32_t* __restrict__ sen, const int32_t* __restrict__ n_frames,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ band_pen, const uint8_t* __restrict__ band_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    const int32_t* __restrict__ entry, const uint8_t* __restrict__ final_mask,
    int T, int P, int K, int W, int16_t* __restrict__ tok,
    int32_t* __restrict__ tsc, int16_t* __restrict__ path,
    int32_t* __restrict__ pscore, int32_t* __restrict__ fscore) {
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
  // this row's graph
  tp += (size_t)b * P * 12;
  pred_idx += (size_t)b * P * K;
  pred_pen += (size_t)b * P * K;
  pred_ok += (size_t)b * P * K;
  band_pen += (size_t)b * W * P;
  band_ok += (size_t)b * W * P;
  astart += (size_t)b * P;
  aend += (size_t)b * P;
  entry += (size_t)b * P;
  final_mask += (size_t)b * P;

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
    const size_t row_t = ((size_t)b * T + t) * S;
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    for (int p = tid; p < P; p += nthr) {
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      lbest = max(lbest, sst::hmm_update(score + 3 * p, hist + 3 * p, osc + p,
                                         ohi + p, tp + 12 * p,
                                         sen + row_t + 3 * p, act, renorm,
                                         best_prev));
      anext[p] = act && t + 1 <= aend[p];
    }
    const int32_t best = sst::block_max(lbest, wmax);

    // -- phone transitions, entries and token record --
    const int nf = t + 1;
    for (int p = tid; p < P; p += nthr) {
      int32_t es = kWorst, eh = -1;
      bool eok = false;
      if (kBand) {
        for (int i = 0; i < W; ++i) {
          const int src = p - (W - i);
          if (src < 0) continue;  // absent: its value could never win
          const bool ok = band_ok[i * P + p] && anext[src];
          const int32_t val = ok ? sst::wadd(osc[src], band_pen[i * P + p]) : kWorst;
          if (val > es) {  // strict: the earlier slot wins ties
            es = val;
            eh = ohi[src];
            eok = ok;
          }
        }
      } else {
        for (int k = 0; k < K; ++k) {
          const int src = pred_idx[p * K + k];
          const bool ok = pred_ok[p * K + k] && anext[src];
          const int32_t val = ok ? sst::wadd(osc[src], pred_pen[p * K + k]) : kWorst;
          if (val > es) {
            es = val;
            eh = ohi[src];
            eok = ok;
          }
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
      int16_t* tk = tok + row_t + 3 * p;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          tk[e] = (int16_t)hist[3 * p + e];
          hist[3 * p + e] = 3 * p + e;
          if (kScores) tsc[row_t + 3 * p + e] = score[3 * p + e];
        }
      } else {
        tk[0] = tk[1] = tk[2] = -1;
        if (kScores) tsc[row_t + 3 * p] = tsc[row_t + 3 * p + 1] = tsc[row_t + 3 * p + 2] = -1;
      }
    }
    best_prev = best;
    __syncthreads();
  }

  if (tid == 0) {
    // masked final-node select: first max over node index
    int node = 0;
    int32_t fbest = final_mask[0] ? osc[0] : kWorst;
    for (int p = 1; p < P; ++p) {
      const int32_t v = final_mask[p] ? osc[p] : kWorst;
      if (v > fbest) {
        fbest = v;
        node = p;
      }
    }
    fscore[b] = fbest;
    // backtrace (backtrace_batch); the tokens are this block's own
    // global writes, visible after the loop's last barrier
    int32_t cur = fbest > kWorst ? ohi[node] : -1;
    int32_t cur_sc = fbest;
    for (int t = T - 1; t >= 0; --t) {
      const size_t row_t = ((size_t)b * T + t) * S;
      const bool inside = cur >= 0 && cur < S;
      const int32_t cand = inside ? (int32_t)tok[row_t + cur] : kMissing;
      path[(size_t)b * T + t] = (int16_t)(t < n ? cur : -1);
      if (kScores) {
        const int32_t csc = inside ? tsc[row_t + cur] : kMissing;
        pscore[(size_t)b * T + t] = t < n ? cur_sc : -1;
        if (t < n - 1) cur_sc = csc;
      }
      if (t < n - 1) cur = cand;
    }
  }
}

template <bool kBand, bool kScores>
int launch(const int32_t* sen, const int32_t* n_frames, const int32_t* tp,
           const int32_t* pred_idx, const int32_t* pred_pen,
           const uint8_t* pred_ok, const int32_t* band_pen,
           const uint8_t* band_ok, const int32_t* astart, const int32_t* aend,
           const int32_t* entry, const uint8_t* final_mask, int B, int T, int P,
           int K, int W, int16_t* tok, int32_t* tsc, int16_t* path,
           int32_t* pscore, int32_t* fscore, cudaStream_t stream) {
  const size_t smem = sst::smem_bytes(P);
  auto kernel = viterbi_rows_kernel<kBand, kScores>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = min(1024, (P + 31) / 32 * 32);
  kernel<<<B, threads, smem, stream>>>(
      sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen, band_ok,
      astart, aend, entry, final_mask, T, P, K, W, tok, tsc, path, pscore,
      fscore);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sst_viterbi_rows(
    const int32_t* sen, const int32_t* n_frames, const int32_t* tp,
    const int32_t* pred_idx, const int32_t* pred_pen, const uint8_t* pred_ok,
    const int32_t* band_pen, const uint8_t* band_ok, const int32_t* astart,
    const int32_t* aend, const int32_t* entry, const uint8_t* final_mask,
    int B, int T, int P, int K, int W, int16_t* tok, int32_t* tsc,
    int16_t* path, int32_t* pscore, int32_t* fscore, cudaStream_t stream) {
  if (P <= 0 || K <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  const bool band = W > 0;
  if (band && (band_pen == nullptr || band_ok == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool scores = tsc != nullptr;
  if (scores != (pscore != nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (band) {
    return scores ? launch<true, true>(sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen,
                                       band_ok, astart, aend, entry, final_mask, B, T, P, K, W,
                                       tok, tsc, path, pscore, fscore, stream)
                  : launch<true, false>(sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen,
                                        band_ok, astart, aend, entry, final_mask, B, T, P, K, W,
                                        tok, tsc, path, pscore, fscore, stream);
  }
  return scores ? launch<false, true>(sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen,
                                      band_ok, astart, aend, entry, final_mask, B, T, P, K, W,
                                      tok, tsc, path, pscore, fscore, stream)
                : launch<false, false>(sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen,
                                       band_ok, astart, aend, entry, final_mask, B, T, P, K, W,
                                       tok, tsc, path, pscore, fscore, stream);
}
