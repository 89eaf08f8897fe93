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
// Bound: latency of the frame recurrence, as K4 (viterbi.cu).  Every
// graph table is the row's own (tp [B,P,E,E+1], astart/aend/entry/
// final_mask [B,P]), so a batch of different transcripts (or of one
// decode graph, decode_batch_scored) is one launch.  What the design
// does about the latency:
//
// - the edge loop visits a phone's real predecessors only, n of them
//   from per-row lists src/pen [B, P, Kn] with n [B, P] (enter_strict_at):
//   the K-slot form's lists are build_pred_table's slots in edge order
//   (pred_n: the real slots are a prefix; a decode graph pads K = 126
//   slots for about 2.55 edges a phone), the band form's the slots i
//   with band_ok in i order (offset descending, source ascending;
//   align_torch.band_lists), so each form keeps its tie order.  A
//   skipped slot has the value WORST_SCORE and never wins the strict
//   `>`, so both are exact;
// - a row's phones are spread over the threads of one block or, past
//   what one block holds at two phones a thread, of a thread-block
//   cluster (2-16 blocks, one row a cluster): rank r owns phones
//   [r*Pr, r*Pr + Pr), its state in its own shared memory, and reads a
//   predecessor of another rank through distributed shared memory
//   (cooperative_groups map_shared_rank; ClusterNodes); the frame's two
//   block barriers become cluster barriers and the best score a cluster
//   max (each rank's block max, read by all at the next frame); there a
//   phone of more than 8 predecessors (a decode graph's junctions: up to
//   125) is weighed by a whole warp, each lane the first max of every
//   32nd slot, then the warp's max and the lowest slot holding it, so
//   that no thread chases a hundred remote reads while the cluster waits
//   at its barrier (one block keeps the serial loop: its reads are its
//   own shared memory);
// - each thread owns at most two phones, whose negated tmat row, window,
//   in-degree and first two predecessors stay in registers for the whole
//   frame loop (PhoneConsts), and the next frame's scores of the rank's
//   phones are copied into a shared double buffer with cp.async while
//   the current frame runs (prefetch_row);
// - only a graph past the largest cluster (or a launch asked for one
//   block whose state does not fit it) keeps its state in a global
//   scratch (state_bytes(P, E) a row), its constants loaded at each use.
// The layouts, their plan (sst::plan_for) and the cluster's pieces live
// in viterbi_step.h, where K4's carry form (viterbi.cu) takes them too.
//
// The final select is a first max over node index of the out scores
// masked by final_mask: each rank's first max over its phones, then the
// ranks in order with a strict `>`; a row whose best is WORST backtraces
// from -1, whose masked lookup yields -2^30 (int16 0), as the JAX
// program.  Rank 0 backtraces through the token stack in global memory.
// Every choice is the same integer operations in the same order, so the
// bits never depend on the layout.
//
// This file holds the 3-state forms and the entry points;
// viterbi_rows_e5.cu compiles it again with SST_VIT_E5 defined for the
// 5-state forms alone (sst_viterbi_rows_e5, which sst_viterbi_rows calls
// for E = 5), so the two build in parallel.
#include <type_traits>

#include "viterbi_step.h"

#ifdef SST_VIT_E5
#define SST_VIT_ROWS sst_viterbi_rows_e5
#define SST_VIT_ROWS_CLUSTER sst_viterbi_rows_cluster_e5
#else
#define SST_VIT_ROWS sst_viterbi_rows
#define SST_VIT_ROWS_CLUSTER sst_viterbi_rows_cluster
#endif

namespace {

using sst::dispatch_bool;
using sst::kMissing;
using sst::kWorst;

#ifdef SST_VIT_E5
constexpr int kFormE = 5;
#else
constexpr int kFormE = 3;
#endif

using sst::kCluster;
using sst::kFsel;
using sst::kHbm;

struct RowArgs {
  const int32_t* sen;       // [B, T, S]
  const int32_t* n_frames;  // [B]
  const int32_t* tp;        // [B, P, E*(E+1)]
  const int32_t* src;       // [B, P, K] predecessor lists
  const int32_t* pen;       // [B, P, K]
  const int32_t* nin;       // [B, P] list lengths
  const int32_t* astart;    // [B, P]
  const int32_t* aend;
  const int32_t* entry;
  const uint8_t* final_mask;
  int T, P, K, Pr;          // Pr: phones a rank (P in one block)
  int hcap;                 // heavy phones a block holds (0: none)
  void* tok;                // [B, T, S]
  int32_t* tsc;             // [B, T, S] or NULL
  void* path;               // [B, T]
  int32_t* pscore;          // [B, T] or NULL
  int32_t* fscore;          // [B]
  uint8_t* gstate;          // kHbm: B * state_bytes(P, E)
};

template <int E, typename Tok, bool kScores, int kLay, int kPh, bool kPf>
__global__ void __launch_bounds__(1024) viterbi_rows_kernel(RowArgs a) {
  extern __shared__ __align__(16) int32_t sm[];
  const int CS = kLay == kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank =
      kLay == kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / CS;
  const int P = a.P, T = a.T, K = a.K, Pr = a.Pr;
  const int lo = rank * Pr;
  const int np = max(0, min(P - lo, Pr));  // this rank's phones
  const int S = E * P;
  constexpr int TQ = E * (E + 1);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  char* const sbase = reinterpret_cast<char*>(sm + sst::head_ints(kLay));
  const sst::VitState v = sst::carve(
      kLay == kHbm
          ? static_cast<void*>(a.gstate + (size_t)b * sst::state_bytes(P, E))
          : static_cast<void*>(sbase),
      Pr, E);
  int32_t* const score = v.score;
  int32_t* const hist = v.hist;
  int32_t* const osc = v.osc;
  int32_t* const ohi = v.ohi;
  uint8_t* const anext = v.anext;
  int32_t* const sbuf = reinterpret_cast<int32_t*>(
      sbase + (kLay == kHbm ? 0 : sst::state_bytes(Pr, E)));
  const char* const* const rbase = sst::rank_bases<kLay>(sm);

  // this row's graph, phone-major
  const size_t bp = (size_t)b * P;
  const sst::VitGraph g{a.tp + bp * TQ, a.src + bp * K, a.pen + bp * K,
                        a.nin + bp,     a.astart + bp,  a.aend + bp,
                        TQ,             1,              K,
                        1};
  const int32_t* const entry = a.entry + bp;
  const uint8_t* const final_mask = a.final_mask + bp;
  Tok* const tok = static_cast<Tok*>(a.tok);
  const int n = a.n_frames[b];
  const int32_t* const sen_r = a.sen + (size_t)b * T * S + (size_t)E * lo;

  using KC = sst::Consts<E, kPh>;
  KC kc;
  kc.init(g, lo, np);
  // in a cluster, phones of more than kHeavyN predecessors, each weighed
  // by a warp: their slot in the block's table, or -1
  constexpr bool kHeavy = kLay == kCluster && kPh > 0;
  int32_t* const heavy = sbuf + (kPf ? 2 * E * Pr : 0);
  int hslot[kHeavy ? kPh : 1];
#pragma unroll
  for (int j = 0; j < (kHeavy ? kPh : 1); ++j) hslot[j] = -1;
  if (kHeavy && a.hcap > 0)
    sst::heavy_register<kPh>(kc, np, a.hcap, heavy, hslot);
  for (int p = tid; p < np; p += nthr) {
    score[E * p] = entry[lo + p];
#pragma unroll
    for (int e = 1; e < E; ++e) score[E * p + e] = kWorst;
#pragma unroll
    for (int e = 0; e < E; ++e) hist[E * p + e] = -1;
    osc[p] = kWorst;
    ohi[p] = -1;
  }
  if (kPf) {
    sst::prefetch_row(sbuf, sen_r, E * np);
    sst::cp_async_wait_all();
  }
  const auto nodes = sst::row_nodes<kLay>(sm, v, lo, Pr, rbase);
  int32_t best_prev = 0;
  // every block of the cluster runs (and its rbase is written) before a
  // rank reads another's shared memory
  sst::row_sync<kLay>();
  const int n_heavy = kHeavy && a.hcap > 0 ? min(heavy[0], a.hcap) : 0;
  int32_t* const hres = heavy + 4 + a.hcap;  // [hcap][3]

  for (int t = 0; t < T; ++t) {
    const size_t row_t = ((size_t)b * T + t) * S;
    const int32_t* sen_t =
        kPf ? sbuf + (t & 1) * E * Pr : sen_r + (size_t)t * S;
    if (kPf && t + 1 < T)
      sst::prefetch_row(sbuf + ((t + 1) & 1) * E * Pr,
                        sen_r + (size_t)(t + 1) * S, E * np);
    if (kLay == kCluster && t > 0) best_prev = sst::cluster_best(rbase, CS);
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    // -- HMM update (_eval_3st_lanes / _eval_5st) --
    sst::for_phones<kPh>(np, [&](int p, int j) {
      const auto c = kc.get(g, lo + p, j);
      const bool act = t >= c.ast && t <= c.aen && valid;
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            osc + p, ohi + p, c.tq,
                                            sen_t + E * p, act, renorm,
                                            best_prev));
      anext[p] = act && t + 1 <= c.aen;
    });
    // the block's best over active phones
    const int32_t best = sst::row_block_max<kLay>(lbest, sm);

    // -- the heavy phones' predecessor max, a warp each, with the strict
    // `>` from WORST (enter_strict_at's result) --
    if (kHeavy && n_heavy > 0) {
      sst::weigh_heavy<false>(n_heavy, heavy + 4, hres, lo, g, K, nodes);
      __syncthreads();
    }

    // -- phone transitions, entries and token record --
    const int nf = t + 1;
    sst::for_phones<kPh>(np, [&](int p, int j) {
      const int gp = lo + p;
      const auto c = kc.get(g, gp, j);
      int32_t es, eh;
      bool eok;
      const size_t at = KC::slots_at(g, K, gp);
      if (kHeavy && hslot[j] >= 0) {
        es = hres[3 * hslot[j]];
        eh = hres[3 * hslot[j] + 1];
        eok = hres[3 * hslot[j] + 2] != 0;
      } else {
        sst::enter_strict_at<KC::KR>(c.np, c.src, c.pen, g.pred_idx + at,
                                     g.pred_pen + at, KC::slot_stride(g),
                                     nodes, &es, &eh, &eok);
      }
      const bool act = t >= c.ast && t <= c.aen && valid;
      const bool enter = eok && nf >= c.ast && nf <= c.aen && valid &&
                         (!act || es > score[E * p]);
      if (enter) {
        score[E * p] = es;
        hist[E * p] = eh;
      }
      Tok* tk = tok + row_t + E * gp;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = (Tok)hist[E * p + e];
          hist[E * p + e] = E * gp + e;
          if (kScores) a.tsc[row_t + E * gp + e] = score[E * p + e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = -1;
          if (kScores) a.tsc[row_t + E * gp + e] = -1;
        }
      }
    });
    if (kLay != kCluster) best_prev = best;
    if (kPf) sst::cp_async_wait_all();
    sst::row_sync<kLay>();
  }

  // masked final-node select: this rank's first max over its phones
  if (tid == 0) {
    int node = lo;
    int32_t fbest = np > 0 && final_mask[lo] ? osc[0] : kWorst;
    for (int p = 1; p < np; ++p) {
      const int32_t x = final_mask[lo + p] ? osc[p] : kWorst;
      if (x > fbest) {
        fbest = x;
        node = lo + p;
      }
    }
    sm[kFsel] = fbest;
    sm[kFsel + 1] = node;
    sm[kFsel + 2] = np > 0 ? ohi[node - lo] : -1;
  }
  if (kLay == kCluster) {
    // the tokens of every rank in global memory, and the candidates, before
    // rank 0 reads them
    __threadfence();
    sst::row_sync<kLay>();
  } else {
    __syncthreads();
  }
  int32_t fbest = 0, fh = -1;
  if (rank == 0 && tid == 0) {
    fbest = sm[kFsel];
    fh = sm[kFsel + 2];
    for (int r = 1; r < CS; ++r) {
      const int32_t* h = reinterpret_cast<const int32_t*>(rbase[r]);
      if (h[kFsel] > fbest) {  // strict: the earlier rank (node) wins ties
        fbest = h[kFsel];
        fh = h[kFsel + 2];
      }
    }
  }
  // no rank leaves while rank 0 may still read its shared memory
  if (kLay == kCluster) sst::row_sync<kLay>();
  if (rank == 0 && tid == 0) {
    a.fscore[b] = fbest;
    // backtrace (backtrace_batch) through the token stack in global
    // memory, written by every rank before the barriers above (read from
    // L2: __ldcg)
    Tok* const path = static_cast<Tok*>(a.path);
    int32_t cur = fbest > kWorst ? fh : -1;
    int32_t cur_sc = fbest;
    for (int t = T - 1; t >= 0; --t) {
      const size_t row_t = ((size_t)b * T + t) * S;
      const bool inside = cur >= 0 && cur < S;
      const int32_t cand = inside ? (int32_t)__ldcg(tok + row_t + cur) : kMissing;
      path[(size_t)b * T + t] = (Tok)(t < n ? cur : -1);
      if (kScores) {
        const int32_t csc = inside ? __ldcg(a.tsc + row_t + cur) : kMissing;
        a.pscore[(size_t)b * T + t] = t < n ? cur_sc : -1;
        if (t < n - 1) cur_sc = csc;
      }
      if (t < n - 1) cur = cand;
    }
  }
}

// K6's kernel instances, for sst::with_kernel and the plan
template <int E, typename Tok, bool kScores>
struct RowsKernels {
  static constexpr bool kWide = !std::is_same<Tok, int16_t>::value;
  template <int kLay, int kPh, bool kPf>
  static auto of() {
    return viterbi_rows_kernel<E, Tok, kScores, kLay, kPh, kPf>;
  }
};

template <int V>
using IC = std::integral_constant<int, V>;

template <typename F>
int dispatch_form(int E, int tok_bytes, bool scores, F&& f) {
  if (E != kFormE) return (int)cudaErrorInvalidValue;
  auto go = [&](auto tk) {
    return dispatch_bool(scores, [&](auto s) {
      return f(IC<kFormE>{}, tk, s);
    });
  };
  if (tok_bytes == 2) return go(int16_t{});
  if (tok_bytes == 4) return go(int32_t{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define SST_VIT_ROWS_PARAMS                                                   \
  const int32_t *sen, const int32_t *n_frames, const int32_t *tp,             \
      const int32_t *src, const int32_t *pen, const int32_t *nin,             \
      const int32_t *astart, const int32_t *aend, const int32_t *entry,       \
      const uint8_t *final_mask, int B, int T, int P, int E, int K,           \
      void *tok, int tok_bytes, int32_t *tsc, void *path, int32_t *pscore,    \
      int32_t *fscore, uint8_t *gstate, int cluster, cudaStream_t stream

#ifndef SST_VIT_E5
extern "C" int sst_viterbi_rows_e5(SST_VIT_ROWS_PARAMS);
extern "C" int sst_viterbi_rows_cluster_e5(int P, int E, int tok_bytes,
                                           int scores, int cluster,
                                           int* layout);
#endif

// The layout a launch with these arguments takes, in *layout: the
// cluster size (1 for one block with the state in shared memory), 0 for
// one block with the state in a global scratch of
// B * sst_viterbi_state_bytes(P, E) bytes, -1 where the asked cluster
// does not fit or cannot run.  Returns a CUDA error of the query.
extern "C" int SST_VIT_ROWS_CLUSTER(int P, int E, int tok_bytes, int scores,
                                    int cluster, int* layout) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_rows_cluster_e5(P, E, tok_bytes, scores, cluster,
                                       layout);
#endif
  *layout = -1;
  if (P <= 0 || cluster < 0 || E != kFormE ||
      (tok_bytes != 2 && tok_bytes != 4))
    return (int)cudaSuccess;
  sst::Plan pl;
  bool ok = false;
  const int err = dispatch_form(E, tok_bytes, scores != 0,
                                [&](auto e, auto tk, auto s) {
    using Family = RowsKernels<decltype(e)::value, decltype(tk),
                               decltype(s)::value>;
    return (int)sst::plan_for<Family>(P, E, cluster, &pl, &ok);
  });
  if (err == 0 && ok) *layout = pl.layout == kHbm ? 0 : pl.cs;
  return err;
}

extern "C" int SST_VIT_ROWS(SST_VIT_ROWS_PARAMS) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_rows_e5(sen, n_frames, tp, src, pen, nin, astart,
                               aend, entry, final_mask, B, T, P, E, K, tok,
                               tok_bytes, tsc, path, pscore, fscore, gstate,
                               cluster, stream);
#endif
  if (P <= 0 || K <= 0 || cluster < 0) return (int)cudaErrorInvalidValue;
  const bool scores = tsc != nullptr;
  if (scores != (pscore != nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  return dispatch_form(E, tok_bytes, scores, [&](auto e, auto tk, auto s) {
    constexpr int kE = decltype(e)::value;
    using Tok = decltype(tk);
    using Family = RowsKernels<kE, Tok, decltype(s)::value>;
    sst::Plan pl;
    // cluster 0 here means the global-state layout that
    // sst_viterbi_rows_cluster returned as 0
    if (cluster == 0) {
      pl = sst::one_block(P, kE);
      if (pl.layout != kHbm) return (int)cudaErrorInvalidValue;
    } else {
      bool ok = false;
      const cudaError_t err = sst::plan_for<Family>(P, kE, cluster, &pl, &ok);
      if (err != cudaSuccess) return (int)err;
      if (!ok || pl.layout == kHbm) return (int)cudaErrorInvalidValue;
    }
    if ((pl.layout == kHbm) != (gstate != nullptr))
      return (int)cudaErrorInvalidValue;
    const RowArgs args{sen,    n_frames, tp,    src,    pen,    nin,
                       astart, aend,     entry, final_mask, T,  P,
                       K,      pl.Pr,    pl.hcap, tok,  tsc,    path,
                       pscore, fscore,   gstate};
    return sst::with_kernel<Family>(pl, [&](auto kernel) {
      return sst::launch(kernel, pl, B, stream, args);
    });
  });
}
