// K6 `viterbi_rows`: the per-row-graph batch Viterbi, masked final-node
// select and backtrace (with path scores) in one persistent kernel.
//
// Replaces the jitted XLA programs B4 and B5 in their per-row forms
// (B6's Viterbi) of the JAX package: soundswallower_tpu/ops/align_jax.py
// align_viterbi_batch over stack_graphs tensors (make_vit_step_lanes'
// per-lane K-slot gathers and its banded row shifts, _eval_3st_lanes and
// _eval_5st), the masked select of soundswallower_tpu/aligner.py
// _vit_full_mg.run, and backtrace_batch, with the token-score stack and
// path scores when want_scores is on.
//
// Bound: latency of the frame recurrence, as K4 (viterbi.cu): one block
// owns one row and loops over all frames, one thread per phone, and has
// K4's forms: E = 3 or 5, int16 or int32 tokens and paths, the row's
// state in shared memory or in a global scratch.  What differs from K4:
// every graph table is the row's own (tp [B,P,E,E+1], pred_* [B,P,K],
// band_* [B,W,P], astart/aend/entry/final_mask [B,P]), so a batch of
// different transcripts (or of one decode graph, decode_batch_scored) is
// one launch.  The TPU program turned the per-lane predecessor gathers
// into W static row shifts (band form) because its gathers were slow; on
// the GPU both forms are plain reads, and both are kept because they
// break ties differently:
//
// * band form: slot i holds the edge p-(W-i) -> p; slots are visited in
//   i order (offset descending, source ascending) with a strict `>`; a
//   source below 0 is absent;
// * K-slot form (no band: an edge offset < 1 or > w_cap, as every cyclic
//   decode graph has): the slots of build_pred_table in edge order,
//   strict `>`.
//
// Final select: first max over node index of the out scores masked by
// final_mask; a row whose best is WORST backtraces from -1, whose
// masked lookup yields -2^30 (int16 0), as the JAX program.
//
// This file holds the 3-state forms and the entry point;
// viterbi_rows_e5.cu compiles it again with SST_VIT_E5 defined for the
// 5-state forms alone (sst_viterbi_rows_e5, which sst_viterbi_rows calls
// for E = 5), so the two build in parallel.
#include <type_traits>

#include "viterbi_step.h"

#ifdef SST_VIT_E5
#define SST_VIT_ROWS sst_viterbi_rows_e5
#else
#define SST_VIT_ROWS sst_viterbi_rows
#endif

namespace {

using sst::kMissing;
using sst::kWorst;

template <int E, typename Tok, bool kGlobal, bool kBand, bool kScores>
__global__ void __launch_bounds__(1024) viterbi_rows_kernel(
    const int32_t* __restrict__ sen, const int32_t* __restrict__ n_frames,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ band_pen, const uint8_t* __restrict__ band_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    const int32_t* __restrict__ entry, const uint8_t* __restrict__ final_mask,
    int T, int P, int K, int W, Tok* __restrict__ tok,
    int32_t* __restrict__ tsc, Tok* __restrict__ path,
    int32_t* __restrict__ pscore, int32_t* __restrict__ fscore,
    uint8_t* gstate) {
  extern __shared__ int32_t sm[];
  int32_t* wmax = sm;  // [32]
  const int b = blockIdx.x;
  const sst::VitState v = sst::carve(
      kGlobal ? static_cast<void*>(gstate + (size_t)b * sst::state_bytes(P, E))
              : static_cast<void*>(sm + 32),
      P, E);
  int32_t* const score = v.score;
  int32_t* const hist = v.hist;
  int32_t* const osc = v.osc;
  int32_t* const ohi = v.ohi;
  uint8_t* const anext = v.anext;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n = n_frames[b];
  const int S = E * P;
  constexpr int TQ = E * (E + 1);
  // this row's graph
  tp += (size_t)b * P * TQ;
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
    score[E * p] = entry[p];
#pragma unroll
    for (int e = 1; e < E; ++e) score[E * p + e] = kWorst;
#pragma unroll
    for (int e = 0; e < E; ++e) hist[E * p + e] = -1;
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
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            osc + p, ohi + p, tp + TQ * p,
                                            sen + row_t + E * p, act, renorm,
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
                         (!act || es > score[E * p]);
      if (enter) {
        score[E * p] = es;
        hist[E * p] = eh;
      }
      Tok* tk = tok + row_t + E * p;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = (Tok)hist[E * p + e];
          hist[E * p + e] = E * p + e;
          if (kScores) tsc[row_t + E * p + e] = score[E * p + e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = -1;
          if (kScores) tsc[row_t + E * p + e] = -1;
        }
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
      path[(size_t)b * T + t] = (Tok)(t < n ? cur : -1);
      if (kScores) {
        const int32_t csc = inside ? tsc[row_t + cur] : kMissing;
        pscore[(size_t)b * T + t] = t < n ? cur_sc : -1;
        if (t < n - 1) cur_sc = csc;
      }
      if (t < n - 1) cur = cand;
    }
  }
}

template <typename F>
int dispatch_bool(bool x, F&& f) {
  return x ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace

#define SST_VIT_ROWS_PARAMS                                                   \
  const int32_t *sen, const int32_t *n_frames, const int32_t *tp,             \
      const int32_t *pred_idx, const int32_t *pred_pen,                       \
      const uint8_t *pred_ok, const int32_t *band_pen,                        \
      const uint8_t *band_ok, const int32_t *astart, const int32_t *aend,     \
      const int32_t *entry, const uint8_t *final_mask, int B, int T, int P,   \
      int E, int K, int W, void *tok, int tok_bytes, int32_t *tsc,            \
      void *path, int32_t *pscore, int32_t *fscore, uint8_t *gstate,          \
      cudaStream_t stream

#ifdef SST_VIT_E5
constexpr int kFormE = 5;
#else
constexpr int kFormE = 3;
extern "C" int sst_viterbi_rows_e5(SST_VIT_ROWS_PARAMS);
#endif

extern "C" int SST_VIT_ROWS(SST_VIT_ROWS_PARAMS) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_rows_e5(sen, n_frames, tp, pred_idx, pred_pen,
                               pred_ok, band_pen, band_ok, astart, aend,
                               entry, final_mask, B, T, P, E, K, W, tok,
                               tok_bytes, tsc, path, pscore, fscore, gstate,
                               stream);
#endif
  if (P <= 0 || K <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (E != kFormE || (tok_bytes != 2 && tok_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const bool band = W > 0;
  if (band && (band_pen == nullptr || band_ok == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool scores = tsc != nullptr;
  if (scores != (pscore != nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const bool global = gstate != nullptr;
  const size_t smem = sst::smem_bytes(P, E, global);
  auto run = [&](auto e, auto tk) {
    constexpr int kE = decltype(e)::value;
    using Tok = decltype(tk);
    return dispatch_bool(global, [&](auto g) {
      return dispatch_bool(band, [&](auto bd) {
        return dispatch_bool(scores, [&](auto s) {
          auto kernel = viterbi_rows_kernel<kE, Tok, decltype(g)::value,
                                            decltype(bd)::value,
                                            decltype(s)::value>;
          const cudaError_t err = sst::allow_smem(kernel, smem);
          if (err != cudaSuccess) return (int)err;
          kernel<<<B, sst::vit_threads(P), smem, stream>>>(
              sen, n_frames, tp, pred_idx, pred_pen, pred_ok, band_pen,
              band_ok, astart, aend, entry, final_mask, T, P, K, W,
              static_cast<Tok*>(tok), tsc, static_cast<Tok*>(path), pscore,
              fscore, gstate);
          return (int)cudaGetLastError();
        });
      });
    });
  };
  using IE = std::integral_constant<int, kFormE>;
  return tok_bytes == 2 ? run(IE{}, int16_t{}) : run(IE{}, int32_t{});
}
