// K4 `viterbi_batch`: the shared-graph batch Viterbi, final-node select
// and backtrace (with path scores) in one persistent kernel.
//
// Replaces the jitted XLA programs B4 and B5 of the JAX package:
// soundswallower_tpu/ops/align_jax.py align_viterbi_batch (with
// make_vit_step_lanes, _eval_3st_lanes, _eval_5st, vit_carry0_lanes),
// the final-node select of soundswallower_tpu/aligner.py _vit_full.run
// and align_jax.py backtrace_batch, with the token-score stack and path
// scores when want_scores is on.
//
// Bound: latency of the frame recurrence.  The TPU program ran one scan
// step per frame with the batch in the vector lanes; here one block owns
// one utterance row and loops over all frames itself (no launch per
// frame), one thread per phone.  Each frame reads the row's S = E*P
// senone scores and writes S tokens; two block barriers order the HMM
// update, the predecessor max and the entries.  Rows run in parallel,
// one block each.
//
// Forms (template arguments): E = 3 or 5 emitting states (hmm.c's two
// left-to-right updates); int16 tokens and paths, or int32 ones where
// S >= 32767 (align_jax.py tok_dtype); the row's Viterbi state (score/
// hist [P, E], out_score/out_hist [P], active_next [P]) in shared memory,
// or, for a graph whose state does not fit a block's shared memory, in a
// global scratch of state_bytes(P, E) per row that the caller allocates
// (the L2 holds it); with or without the token-score stack.
//
// Integer semantics follow the JAX program exactly: state_align_search's
// renormalization, hmm.c's update including the reuse of t2 when the 0->2
// skip is absent (3 states only), K predecessor slots in edge order with a
// strict `>`, first-max final-node select, and the backtrace's masked
// lookup, which yields -2^30 (int16 0) for a state outside [0, S).
// Additions wrap like XLA's int32 (unsigned arithmetic).
//
// The carry form `sst_viterbi_chunk` (B9) replaces the single-utterance
// programs of the JAX package: align_jax.py make_vit_step scanned from
// vit_carry0 (align_viterbi, and streaming.py AlignStream's 128-frame
// chunks), with _viterbi_graph's final-node select and align_jax.py
// backtrace when it is asked for a path.  One block runs frames t0 ..
// t0+C-1 of one utterance against absolute astart/aend, from the carry
// (score, hist, out_score, out_hist, best_prev) it is given, and writes
// the carry back; in the global layout it works on the carry tensors in
// place.  It shares the frame step with K4 (renormalization, hmm_update,
// best over active phones, token record); the one difference is
// make_vit_step's predecessor choice, jnp.argmax over the K slots: the
// first slot's value is the start, so a slot at or below WORST_SCORE can
// still win, where K4's strict `>` from WORST_SCORE takes none.  Padded
// frames (t >= n) renormalize the scores, as the scan does.
//
// This file holds the 3-state forms and the entry points; viterbi_e5.cu
// compiles it again with SST_VIT_E5 defined for the 5-state forms alone
// (entry points sst_viterbi_batch_e5, sst_viterbi_chunk_e5, which the
// entry points here call for E = 5), so the two build in parallel.
#include <type_traits>

#include "viterbi_step.h"

#ifdef SST_VIT_E5
#define SST_VIT_BATCH sst_viterbi_batch_e5
#define SST_VIT_CHUNK sst_viterbi_chunk_e5
#else
#define SST_VIT_BATCH sst_viterbi_batch
#define SST_VIT_CHUNK sst_viterbi_chunk
#endif

namespace {

#ifdef SST_VIT_E5
constexpr int kFormE = 5;
#else
constexpr int kFormE = 3;
#endif

using sst::kMissing;
using sst::kWorst;

template <int E, typename Tok, bool kGlobal, bool kScores>
__global__ void __launch_bounds__(1024) viterbi_kernel(
    const int32_t* __restrict__ sen, const int32_t* __restrict__ n_frames,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    const int32_t* __restrict__ entry, const int32_t* __restrict__ fin, int T,
    int P, int K, int n_fin, Tok* __restrict__ tok,
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
    const int32_t* sen_t = sen + row_t;
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    // -- HMM update (_eval_3st_lanes / _eval_5st) --
    for (int p = tid; p < P; p += nthr) {
      const bool act = t >= astart[p] && t <= aend[p] && valid;
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            osc + p, ohi + p, tp + TQ * p,
                                            sen_t + E * p, act, renorm,
                                            best_prev));
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
    fscore[b] = fbest;
    // backtrace (backtrace_batch); the tokens are this block's own
    // global writes, visible after the loop's last barrier
    int32_t cur = ohi[fnode];
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

template <int E, typename Tok, bool kGlobal>
__global__ void __launch_bounds__(1024) viterbi_chunk_kernel(
    const int32_t* __restrict__ sen, int t0, int n,
    const int32_t* __restrict__ tp, const int32_t* __restrict__ pred_idx,
    const int32_t* __restrict__ pred_pen, const uint8_t* __restrict__ pred_ok,
    const int32_t* __restrict__ astart, const int32_t* __restrict__ aend,
    int32_t* c_score, int32_t* c_hist, int32_t* c_osc, int32_t* c_ohi,
    int32_t* c_best, int C, int P, int K, Tok* __restrict__ tok,
    const int32_t* __restrict__ fin, int n_fin, int32_t* __restrict__ path,
    int32_t* __restrict__ fscore, uint8_t* g_anext) {
  extern __shared__ int32_t sm[];
  int32_t* wmax = sm;  // [32]
  // the global layout works on the carry in place
  const sst::VitState v = kGlobal
      ? sst::VitState{c_score, c_hist, c_osc, c_ohi, g_anext}
      : sst::carve(sm + 32, P, E);
  int32_t* const score = v.score;
  int32_t* const hist = v.hist;
  int32_t* const osc = v.osc;
  int32_t* const ohi = v.ohi;
  uint8_t* const anext = v.anext;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int S = E * P;
  constexpr int TQ = E * (E + 1);

  if (!kGlobal) {
    for (int p = tid; p < P; p += nthr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        score[E * p + e] = c_score[E * p + e];
        hist[E * p + e] = c_hist[E * p + e];
      }
      osc[p] = c_osc[p];
      ohi[p] = c_ohi[p];
    }
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
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            osc + p, ohi + p, tp + TQ * p,
                                            sen_t + E * p, act, renorm,
                                            best_prev));
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
                         (!act || es > score[E * p]);
      if (enter) {
        score[E * p] = es;
        hist[E * p] = eh;
      }
      Tok* tk = tok + (size_t)c * S + E * p;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = (Tok)hist[E * p + e];
          hist[E * p + e] = E * p + e;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) tk[e] = -1;
      }
    }
    best_prev = best;
    __syncthreads();
  }

  if (!kGlobal) {
    for (int p = tid; p < P; p += nthr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        c_score[E * p + e] = score[E * p + e];
        c_hist[E * p + e] = hist[E * p + e];
      }
      c_osc[p] = osc[p];
      c_ohi[p] = ohi[p];
    }
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

// Calls f(integral_constant<int, E>, Tok{}) for this file's E and 2- or
// 4-byte tokens; cudaErrorInvalidValue for anything else.
template <typename F>
int dispatch_form(int E, int tok_bytes, F&& f) {
  using IE = std::integral_constant<int, kFormE>;
  if (E == kFormE && tok_bytes == 2) return f(IE{}, int16_t{});
  if (E == kFormE && tok_bytes == 4) return f(IE{}, int32_t{});
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int dispatch_bool(bool x, F&& f) {
  return x ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace

#define SST_VIT_CHUNK_PARAMS                                                  \
  const int32_t *sen, int t0, int n, const int32_t *tp,                       \
      const int32_t *pred_idx, const int32_t *pred_pen,                       \
      const uint8_t *pred_ok, const int32_t *astart, const int32_t *aend,     \
      int32_t *score, int32_t *hist, int32_t *osc, int32_t *ohi,              \
      int32_t *best_prev, int C, int P, int E, int K, void *tok,              \
      int tok_bytes, const int32_t *fin, int n_fin, int32_t *path,            \
      int32_t *fscore, uint8_t *anext, cudaStream_t stream
#define SST_VIT_BATCH_PARAMS                                                  \
  const int32_t *sen, const int32_t *n_frames, const int32_t *tp,             \
      const int32_t *pred_idx, const int32_t *pred_pen,                       \
      const uint8_t *pred_ok, const int32_t *astart, const int32_t *aend,     \
      const int32_t *entry, const int32_t *fin, int B, int T, int P, int E,   \
      int K, int n_fin, void *tok, int tok_bytes, int32_t *tsc, void *path,   \
      int32_t *pscore, int32_t *fscore, uint8_t *gstate, cudaStream_t stream

#ifndef SST_VIT_E5
extern "C" int sst_viterbi_chunk_e5(SST_VIT_CHUNK_PARAMS);
extern "C" int sst_viterbi_batch_e5(SST_VIT_BATCH_PARAMS);
#endif

extern "C" int SST_VIT_CHUNK(SST_VIT_CHUNK_PARAMS) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_chunk_e5(sen, t0, n, tp, pred_idx, pred_pen, pred_ok,
                                astart, aend, score, hist, osc, ohi,
                                best_prev, C, P, E, K, tok, tok_bytes, fin,
                                n_fin, path, fscore, anext, stream);
#endif
  if (P <= 0 || K <= 0 || (fin != nullptr && n_fin <= 0))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaSuccess;
  const bool global = anext != nullptr;
  const size_t smem = sst::smem_bytes(P, E, global);
  return dispatch_form(E, tok_bytes, [&](auto e, auto tk) {
    constexpr int kE = decltype(e)::value;
    using Tok = decltype(tk);
    return dispatch_bool(global, [&](auto g) {
      auto kernel = viterbi_chunk_kernel<kE, Tok, decltype(g)::value>;
      const cudaError_t err = sst::allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<1, sst::vit_threads(P), smem, stream>>>(
          sen, t0, n, tp, pred_idx, pred_pen, pred_ok, astart, aend, score,
          hist, osc, ohi, best_prev, C, P, K, static_cast<Tok*>(tok), fin,
          n_fin, path, fscore, anext);
      return (int)cudaGetLastError();
    });
  });
}

#ifndef SST_VIT_E5
extern "C" int sst_viterbi_smem_bytes(int P, int E) {
  return (int)sst::smem_bytes(P, E, false);
}

extern "C" int64_t sst_viterbi_state_bytes(int P, int E) {
  return (int64_t)sst::state_bytes(P, E);
}
#endif

extern "C" int SST_VIT_BATCH(SST_VIT_BATCH_PARAMS) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_batch_e5(sen, n_frames, tp, pred_idx, pred_pen,
                                pred_ok, astart, aend, entry, fin, B, T, P, E,
                                K, n_fin, tok, tok_bytes, tsc, path, pscore,
                                fscore, gstate, stream);
#endif
  if (P <= 0 || K <= 0 || n_fin <= 0) return (int)cudaErrorInvalidValue;
  const bool scores = tsc != nullptr;
  if (scores != (pscore != nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const bool global = gstate != nullptr;
  const size_t smem = sst::smem_bytes(P, E, global);
  return dispatch_form(E, tok_bytes, [&](auto e, auto tk) {
    constexpr int kE = decltype(e)::value;
    using Tok = decltype(tk);
    return dispatch_bool(global, [&](auto g) {
      return dispatch_bool(scores, [&](auto s) {
        auto kernel = viterbi_kernel<kE, Tok, decltype(g)::value,
                                     decltype(s)::value>;
        const cudaError_t err = sst::allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<B, sst::vit_threads(P), smem, stream>>>(
            sen, n_frames, tp, pred_idx, pred_pen, pred_ok, astart, aend,
            entry, fin, T, P, K, n_fin, static_cast<Tok*>(tok), tsc,
            static_cast<Tok*>(path), pscore, fscore, gstate);
        return (int)cudaGetLastError();
      });
    });
  });
}
