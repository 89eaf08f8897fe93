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
// one block each.  What the design does about the latency:
//
// - the edge loop is bounded by each phone's in-degree (pred_n): a
//   phone's real slots are a prefix of its K padded ones, so the loop
//   visits those and never reads pred_ok (a decode graph pads a few
//   nodes' in-degree of a hundred onto every node: K = 125 slots where
//   the graph has about 2.55 edges a phone);
// - where a thread owns at most two phones (P <= 2 * threads), the
//   phone's negated tmat row, active window, in-degree and first two
//   predecessor slots sit in registers for the whole frame loop;
// - where they do and the shared-layout state and two rows of S scores
//   fit a block's shared memory, the next frame's scores are copied into a
//   double buffer with cp.async while the current frame runs, so no
//   frame waits on device memory for its scores;
// - elsewhere (the constants read at every frame) the tmat rows and
//   predecessor slots come from slot-major copies ([E*(E+1), P],
//   [K, P]), so a warp's 32 phones read one line per entry, not 32
//   sectors 48 or 500 bytes apart;
// - the block's best score takes one shared load a lane after its
//   barrier (block_max_warps).
// The launcher takes the second to fourth from what it sees (P, E and
// the block's threads; dispatch_layout); each is the same integer
// operations on the same values in the same order, so the bits never
// depend on the choice.  Prefetch goes with registers only: without
// them a frame waits on the L1/L2 constants, not on its scores, and
// the prefetch alone measured slower (PERF.md).
//
// Forms (template arguments): E = 3 or 5 emitting states (hmm.c's two
// left-to-right updates); int16 tokens and paths, or int32 ones where
// S >= 32767 (align_jax.py tok_dtype; such a graph never fits shared
// memory); the row's Viterbi state (score/hist [P, E], out_score/
// out_hist [P], active_next [P]) in shared memory, or, for a graph whose
// state does not fit a block's shared memory, in a global scratch of
// state_bytes(P, E) per row that the caller allocates (the L2 holds it);
// with or without the token-score stack.
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
// backtrace when it is asked for a path, and each chunk of the long
// form's ring (soundswallower_tpu/parallel/seqpipe.py).  One launch runs
// frames t0 .. t0+C-1 of R utterance rows against absolute astart/aend,
// each from the carry (score, hist, out_score, out_hist, best_prev) it
// is given, and writes the carries back.  A row runs on K6's layouts,
// chosen by K6's plan (viterbi_step.h, sst::plan_for) from P and E:
//
// - one block where it holds each thread's phones in registers (P <=
//   2,048: a stream's graph, a single utterance of a story's size, the
//   long form's rows of a minute), with the prefetch;
// - past that, a thread-block cluster of 2-16 blocks: the smallest whose
//   ranks hold at most kChunkRankPhones = 512 phones (or 16 blocks),
//   where R clusters of it can be resident at once, else the next smaller
//   that holds the row (a chapter of 3-10 minutes, 3,700-12,600 phones,
//   takes 8 or 16 blocks; kChunkRankPhones below has the measurements):
//   rank r owns phones [r*Pr, r*Pr + Pr), keeps their state in its
//   shared memory, their constants in registers and the next frame's
//   scores of its phones in a cp.async double buffer; it loads its
//   phones' carry at the launch's start and stores it at its end; a
//   predecessor of another rank is read through distributed
//   shared memory; the frame's two barriers are cluster barriers and
//   best_prev the cluster's max of the ranks' block maxima; a phone of
//   more than 8 predecessors is weighed by a warp, which returns the
//   lowest slot holding the maximum under the argmax rule below; with a
//   final select, rank 0 reads the final nodes' out scores in fin's
//   order through distributed shared memory and backtraces through the
//   token stack in global memory;
// - one block with the state in the carries themselves (global memory)
//   only past a cluster of 16 (or where one block is asked for and its
//   shared memory does not hold the row).
//
// One row alone fills 1 to 16 of the card's 132 SMs, so the long form
// still puts all of a rank's rows into one launch.  It shares the frame
// step with K4 (renormalization, hmm_update, best over active phones,
// token record, the options above); the one difference is make_vit_step's
// predecessor choice, jnp.argmax over the K slots: the first slot's value
// is the start, so a slot at or below WORST_SCORE can still win, where
// K4's strict `>` from WORST_SCORE takes none; its bounded loop weighs
// the first padded slot after the real ones (enter_argmax).  Padded
// frames (t >= n) renormalize the scores, as the scan does.  Every layout
// is the same integer operations in the same order, so the bits never
// depend on it.
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
#define SST_VIT_CHUNK_CLUSTER sst_viterbi_chunk_cluster_e5
#else
#define SST_VIT_BATCH sst_viterbi_batch
#define SST_VIT_CHUNK sst_viterbi_chunk
#define SST_VIT_CHUNK_CLUSTER sst_viterbi_chunk_cluster
#endif

namespace {

#ifdef SST_VIT_E5
constexpr int kFormE = 5;
#else
constexpr int kFormE = 3;
#endif

using sst::dispatch_bool;
using sst::kMaxSmemBytes;
using sst::kMissing;
using sst::kRegSlots;
using sst::kWorst;


using Graph = sst::VitGraph;

template <int E, typename Tok, bool kGlobal, bool kScores, int kPh,
          bool kPf>
__global__ void __launch_bounds__(1024) viterbi_kernel(
    const int32_t* __restrict__ sen, const int32_t* __restrict__ n_frames,
    Graph g, const int32_t* __restrict__ entry,
    const int32_t* __restrict__ fin, int T, int P, int K, int n_fin,
    Tok* __restrict__ tok, int32_t* __restrict__ tsc, Tok* __restrict__ path,
    int32_t* __restrict__ pscore, int32_t* __restrict__ fscore,
    uint8_t* gstate) {
  extern __shared__ __align__(16) int32_t sm[];  // [32] warp maxima, state
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
  // [2][S] prefetch rows after the shared-layout state
  int32_t* const sbuf = sm + 32 + sst::state_bytes(P, E) / sizeof(int32_t);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n = n_frames[b];
  const int S = E * P;
  const int32_t* const sen_b = sen + (size_t)b * T * S;

  using KC = sst::Consts<E, kPh>;
  KC kc;
  kc.init(g, 0, P);
  for (int p = tid; p < P; p += nthr) {
    score[E * p] = entry[p];
#pragma unroll
    for (int e = 1; e < E; ++e) score[E * p + e] = kWorst;
#pragma unroll
    for (int e = 0; e < E; ++e) hist[E * p + e] = -1;
    osc[p] = kWorst;
    ohi[p] = -1;
  }
  if (kPf) {
    sst::prefetch_row(sbuf, sen_b, S);
    sst::cp_async_wait_all();
  }
  int32_t best_prev = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row_t = ((size_t)b * T + t) * S;
    const int32_t* sen_t = kPf ? sbuf + (t & 1) * S : sen + row_t;
    if (kPf && t + 1 < T)
      sst::prefetch_row(sbuf + ((t + 1) & 1) * S, sen_b + (size_t)(t + 1) * S,
                        S);
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    // -- HMM update (_eval_3st_lanes / _eval_5st) --
    sst::for_phones<kPh>(P, [&](int p, int j) {
      const auto c = kc.get(g, p, j);
      const bool act = t >= c.ast && t <= c.aen && valid;
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            osc + p, ohi + p, c.tq,
                                            sen_t + E * p, act, renorm,
                                            best_prev));
      anext[p] = act && t + 1 <= c.aen;
    });
    // block-wide best over active phones
    const int32_t best = sst::row_block_max<sst::kBlock>(lbest, sm);

    // -- phone transitions, entries and token record --
    const int nf = t + 1;
    sst::for_phones<kPh>(P, [&](int p, int j) {
      const auto c = kc.get(g, p, j);
      int32_t es, eh;
      bool eok;
      const size_t at = KC::slots_at(g, K, p);
      sst::enter_strict_at<KC::KR>(c.np, c.src, c.pen, g.pred_idx + at,
                                   g.pred_pen + at, KC::slot_stride(g),
                                   sst::LocalNodes{osc, ohi, anext}, &es,
                                   &eh, &eok);
      const bool act = t >= c.ast && t <= c.aen && valid;
      const bool enter = eok && nf >= c.ast && nf <= c.aen && valid &&
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
    });
    best_prev = best;
    if (kPf) sst::cp_async_wait_all();
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

// The carry form's arguments: row r's scores sen [R, C, S], frame count
// n_rows[r] (or n_all for every row where n_rows is NULL), carry
// score/hist [R, P, E], osc/ohi [R, P], best [R], tokens [R, C, S]; in
// the global layout the carries are the state and anext [R, P] the rows'
// active_next.
struct ChunkArgs {
  const int32_t* sen;
  int t0, n_all;
  const int32_t* n_rows;
  Graph g;
  int32_t *score, *hist, *osc, *ohi, *best;
  int C, P, K, Pr;  // Pr: phones a rank (P outside a cluster)
  int hcap;         // heavy phones a block holds (0: none)
  void* tok;
  const int32_t* fin;  // [n_fin] or NULL: no final select
  int n_fin;
  int32_t* path;    // [R, C]
  int32_t* fscore;  // [R]
  uint8_t* anext;
};

// The carry form over R rows, one block or one cluster of blocks a row
// (kLay; rank r of a cluster owns phones [r*Pr, r*Pr + Pr)).
template <int E, typename Tok, int kLay, int kPh, bool kPf>
__global__ void __launch_bounds__(1024) viterbi_chunk_kernel(ChunkArgs a) {
  extern __shared__ __align__(16) int32_t sm[];
  constexpr bool kCl = kLay == sst::kCluster;
  const int CS = kCl ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCl ? (int)cg::this_cluster().block_rank() : 0;
  const int r = blockIdx.x / CS;
  const int P = a.P, K = a.K, C = a.C, Pr = a.Pr, t0 = a.t0;
  const int S = E * P;
  const int lo = rank * Pr;
  const int np = kCl ? max(0, min(P - lo, Pr)) : P;  // this rank's phones
  const Graph& g = a.g;
  int32_t* const c_score = a.score + (size_t)r * S;
  int32_t* const c_hist = a.hist + (size_t)r * S;
  int32_t* const c_osc = a.osc + (size_t)r * P;
  int32_t* const c_ohi = a.ohi + (size_t)r * P;
  const int32_t* __restrict__ const sen_r =
      a.sen + (size_t)r * C * S + (size_t)E * lo;
  Tok* __restrict__ const tok = static_cast<Tok*>(a.tok) + (size_t)r * C * S;
  char* const sbase = reinterpret_cast<char*>(sm + sst::head_ints(kLay));
  // the global layout works on the carry in place
  const sst::VitState v = kLay == sst::kHbm
      ? sst::VitState{c_score, c_hist, c_osc, c_ohi,
                      a.anext + (size_t)r * P}
      : sst::carve(sbase, Pr, E);
  int32_t* const score = v.score;
  int32_t* const hist = v.hist;
  uint8_t* const anext = v.anext;
  int32_t* const sbuf = reinterpret_cast<int32_t*>(
      sbase + (kLay == sst::kHbm ? 0 : sst::state_bytes(Pr, E)));
  const char* const* const rbase = sst::rank_bases<kLay>(sm);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n = a.n_rows != nullptr ? a.n_rows[r] : a.n_all;

  using KC = sst::Consts<E, kPh>;
  KC kc;
  kc.init(g, lo, np);
  // in a cluster, phones of more than kHeavyN predecessors, each weighed
  // by a warp: their slot in the block's table, or -1
  constexpr bool kHeavy = kCl && kPh > 0;
  int32_t* const heavy = sbuf + (kPf ? 2 * E * Pr : 0);
  int hslot[kHeavy ? kPh : 1];
#pragma unroll
  for (int j = 0; j < (kHeavy ? kPh : 1); ++j) hslot[j] = -1;
  if (kHeavy && a.hcap > 0)
    sst::heavy_register<kPh>(kc, np, a.hcap, heavy, hslot);
  if (kLay != sst::kHbm) {
    for (int p = tid; p < np; p += nthr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        score[E * p + e] = c_score[E * (lo + p) + e];
        hist[E * p + e] = c_hist[E * (lo + p) + e];
      }
      v.osc[p] = c_osc[lo + p];
      v.ohi[p] = c_ohi[lo + p];
    }
  }
  if (kPf) {
    sst::prefetch_row(sbuf, sen_r, E * np);
    sst::cp_async_wait_all();
  }
  const auto nodes = sst::row_nodes<kLay>(sm, v, lo, Pr, rbase);
  int32_t best_prev = a.best[r];
  // every block of the cluster runs (and its rbase is written) before a
  // rank reads another's shared memory
  sst::row_sync<kLay>();
  const int n_heavy = kHeavy && a.hcap > 0 ? min(heavy[0], a.hcap) : 0;
  int32_t* const hres = heavy + 4 + a.hcap;  // [hcap][3]

  for (int c = 0; c < C; ++c) {
    const int t = t0 + c;
    const int32_t* sen_t =
        kPf ? sbuf + (c & 1) * E * Pr : sen_r + (size_t)c * S;
    if (kPf && c + 1 < C)
      sst::prefetch_row(sbuf + ((c + 1) & 1) * E * Pr,
                        sen_r + (size_t)(c + 1) * S, E * np);
    if (kCl && c > 0) best_prev = sst::cluster_best(rbase, CS);
    const bool valid = t < n;
    const bool renorm = sst::wsub(best_prev, 0x300000) < kWorst;
    int32_t lbest = kWorst;
    sst::for_phones<kPh>(np, [&](int p, int j) {
      const auto k = kc.get(g, lo + p, j);
      const bool act = t >= k.ast && t <= k.aen && valid;
      lbest = max(lbest, sst::hmm_update<E>(score + E * p, hist + E * p,
                                            v.osc + p, v.ohi + p, k.tq,
                                            sen_t + E * p, act, renorm,
                                            best_prev));
      anext[p] = act && t + 1 <= k.aen;
    });
    const int32_t best = sst::row_block_max<kLay>(lbest, sm);
    // the heavy phones' predecessor max, a warp each (enter_argmax's
    // result)
    if (kHeavy && n_heavy > 0) {
      sst::weigh_heavy<true>(n_heavy, heavy + 4, hres, lo, g, K, nodes);
      __syncthreads();
    }

    const int nf = t + 1;
    sst::for_phones<kPh>(np, [&](int p, int j) {
      const int gp = lo + p;
      const auto k = kc.get(g, gp, j);
      // jnp.argmax over the slots: the first maximum, starting at slot 0
      int32_t es, eh;
      bool eok;
      if (kHeavy && hslot[j] >= 0) {
        es = hres[3 * hslot[j]];
        eh = hres[3 * hslot[j] + 1];
        eok = hres[3 * hslot[j] + 2] != 0;
      } else {
        const size_t at = KC::slots_at(g, K, gp);
        sst::enter_argmax<KC::KR>(k.np, K, k.src, k.pen, g.pred_idx + at,
                                  g.pred_pen + at, KC::slot_stride(g), nodes,
                                  &es, &eh, &eok);
      }
      const bool act = t >= k.ast && t <= k.aen && valid;
      const bool enter = eok && nf >= k.ast && nf <= k.aen &&
                         (!act || es > score[E * p]);
      if (enter) {
        score[E * p] = es;
        hist[E * p] = eh;
      }
      Tok* tk = tok + (size_t)c * S + E * gp;
      if (act || enter) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = (Tok)hist[E * p + e];
          hist[E * p + e] = E * gp + e;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) tk[e] = -1;
      }
    });
    if (!kCl) best_prev = best;
    if (kPf) sst::cp_async_wait_all();
    sst::row_sync<kLay>();
  }

  if (kLay != sst::kHbm) {
    for (int p = tid; p < np; p += nthr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        c_score[E * (lo + p) + e] = score[E * p + e];
        c_hist[E * (lo + p) + e] = hist[E * p + e];
      }
      c_osc[lo + p] = v.osc[p];
      c_ohi[lo + p] = v.ohi[p];
    }
  }
  const bool select = a.fin != nullptr;
  // in a cluster, every rank's tokens in global memory before rank 0
  // backtraces through them
  if (kCl && select) {
    __threadfence();
    sst::row_sync<kLay>();
  }
  if (rank == 0 && tid == 0) {
    // the cluster's best of the last frame, posted before its barrier
    a.best[r] = kCl ? sst::cluster_best(rbase, CS) : best_prev;
    if (select) {
      // _viterbi_graph: first max over the final nodes, in fin's order
      int fnode = a.fin[0];
      int32_t fbest = *nodes.ref(fnode).osc;
      for (int i = 1; i < a.n_fin; ++i) {
        const int32_t x = *nodes.ref(a.fin[i]).osc;
        if (x > fbest) {
          fbest = x;
          fnode = a.fin[i];
        }
      }
      a.fscore[r] = fbest;
      // align_jax.py backtrace (frames counted from t0); the gather wraps
      // a negative state and clamps one past the end, as jnp indexing
      // does; another rank's tokens are read from L2 (__ldcg)
      int32_t cur = *nodes.ref(fnode).ohi;
      const int nl = n - t0;
      int32_t* const path_r = a.path + (size_t)r * C;
      for (int c = C - 1; c >= 0; --c) {
        path_r[c] = c < nl ? cur : -1;
        if (c < nl - 1) {
          const Tok* at = tok + (size_t)c * S +
                          min(max(cur < 0 ? cur + S : cur, 0), S - 1);
          cur = (int32_t)(kCl ? __ldcg(at) : *at);
        }
      }
    }
  }
  // no rank leaves while rank 0 may still read its shared memory
  if (kCl) sst::row_sync<kLay>();
}

// The phones a rank of the carry form's cluster takes by choice: past one
// block, the smallest cluster whose ranks hold at most this many (one
// phone a thread), or 16 blocks, where R rows of it can be resident at
// once.  Measured on a chapter-like chain (tools/exp_chunk_clusters.py;
// us a frame, one row): P = 3,731 8.49 (one block) -> 4.86, 3.74, 3.27,
// 3.18 at 2, 4, 8, 16 blocks; P = 7,000 15.70 -> 5.03, 3.94, 3.65 at 4,
// 8, 16; P = 12,586 46.12 (global memory) -> 4.93, 4.77 at 8, 16: the
// time falls until a rank holds about 500 phones, then flattens.  8 rows
// of P = 13,159 take 5.05 at 8 blocks and 9.62 at 16, whose 8 clusters
// are not all resident.  The boundary of one block (2,048 phones of 3
// states) is the register plan's, where a thread still holds its two
// phones' constants, not a measured crossover: at P = 2,048 clusters of
// 4-16 already ran 2.82-2.96 us a frame against one block's 3.10 (2 blocks
// 3.59), while at P = 1,238 one block's 2.40 beat every cluster
// (2.87-3.03).  The gain near 2,048 is under a tenth, and one block
// leaves the other SMs to the launch's other rows.
constexpr int kChunkRankPhones = 512;

// The carry form's kernel instances, for sst::with_kernel and the plan
template <int E, typename Tok>
struct ChunkKernels {
  static constexpr bool kWide = !std::is_same<Tok, int16_t>::value;
  template <int kLay, int kPh, bool kPf>
  static auto of() {
    return viterbi_chunk_kernel<E, Tok, kLay, kPh, kPf>;
  }
};

// Calls f(integral_constant<int, E>, Tok{}) for this file's E and 2- or
// 4-byte tokens; cudaErrorInvalidValue for anything else.
template <typename F>
int dispatch_form(int E, int tok_bytes, F&& f) {
  using IE = std::integral_constant<int, kFormE>;
  if (E == kFormE && tok_bytes == 2) return f(IE{}, int16_t{});
  if (E == kFormE && tok_bytes == 4) return f(IE{}, int32_t{});
  return (int)cudaErrorInvalidValue;
}

// The graph tables a launch reads: the slot-major copies (tables[3..5])
// where `sm` (the phones' constants are read at every frame), else the
// [P, ...] ones (tables[0..2]).
Graph graph(const int32_t* const* tables, const int32_t* pred_n,
            const int32_t* astart, const int32_t* aend, int P, int E, int K,
            bool sm) {
  const int TQ = E * (E + 1);
  const int32_t* const* t = tables + (sm ? 3 : 0);
  return Graph{t[0],       t[1],        t[2],       pred_n, astart,
               aend,       sm ? 1 : TQ, sm ? P : 1, sm ? 1 : K,
               sm ? P : 1};
}

// The layout and the frame step of one K4 launch: f(global, phones in
// registers, prefetch) as integral constants (sst::one_block's choice).
// The shared layout holds int16 tokens only (S >= 32767 never fits
// shared memory); in it, a thread's phones sit in registers where it owns
// at most two, and then the next frame's scores are prefetched where two
// rows fit beside the state.  The global layout takes neither.
template <typename Tok, typename F>
int dispatch_layout(bool global, int P, int E, int threads, F&& f) {
  using F0 = std::false_type;
  if (global)
    return f(std::true_type{}, std::integral_constant<int, 0>{}, F0{});
  if constexpr (!std::is_same<Tok, int16_t>::value) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int ph = sst::vit_reg_phones(P, threads);
    const bool pf = ph > 0 && sst::smem_bytes_prefetch(P, E) <= kMaxSmemBytes;
    return dispatch_bool(pf, [&](auto p) {
      if (ph == 1) return f(F0{}, std::integral_constant<int, 1>{}, p);
      if (ph == 2) return f(F0{}, std::integral_constant<int, 2>{}, p);
      return f(F0{}, std::integral_constant<int, 0>{}, p);
    });
  }
}

}  // namespace

#define SST_VIT_CHUNK_PARAMS                                                  \
  const int32_t *sen, int t0, int n, const int32_t *n_rows,                   \
      const int32_t *tp, const int32_t *pred_idx, const int32_t *pred_pen,    \
      const int32_t *tp_t, const int32_t *pred_idx_t,                         \
      const int32_t *pred_pen_t, const int32_t *pred_n,                       \
      const int32_t *astart, const int32_t *aend,                             \
      int32_t *score, int32_t *hist, int32_t *osc, int32_t *ohi,              \
      int32_t *best_prev, int R, int C, int P, int E, int K, void *tok,       \
      int tok_bytes, const int32_t *fin, int n_fin, int32_t *path,            \
      int32_t *fscore, uint8_t *anext, int cluster, cudaStream_t stream
#define SST_VIT_BATCH_PARAMS                                                  \
  const int32_t *sen, const int32_t *n_frames, const int32_t *tp,             \
      const int32_t *pred_idx, const int32_t *pred_pen, const int32_t *tp_t,  \
      const int32_t *pred_idx_t, const int32_t *pred_pen_t,                   \
      const int32_t *pred_n, const int32_t *astart, const int32_t *aend,      \
      const int32_t *entry, const int32_t *fin, int B, int T, int P, int E,   \
      int K, int n_fin, void *tok, int tok_bytes, int32_t *tsc, void *path,   \
      int32_t *pscore, int32_t *fscore, uint8_t *gstate, cudaStream_t stream

#ifndef SST_VIT_E5
extern "C" int sst_viterbi_chunk_e5(SST_VIT_CHUNK_PARAMS);
extern "C" int sst_viterbi_chunk_cluster_e5(int P, int E, int tok_bytes,
                                            int R, int cluster, int* layout);
extern "C" int sst_viterbi_batch_e5(SST_VIT_BATCH_PARAMS);
#endif

// The carry form's layout for R rows of P phones of E states, in
// *layout: the cluster size (1 for one block with the state in shared
// memory), 0 for one block with the state in the carries (global memory;
// the launch then takes an active_next scratch of R * P bytes), -1 where
// the asked cluster does not fit or cannot run.  cluster 0 chooses
// (sst::plan_for with kChunkRankPhones and R rows resident).  Returns a
// CUDA error of the query.
extern "C" int SST_VIT_CHUNK_CLUSTER(int P, int E, int tok_bytes, int R,
                                     int cluster, int* layout) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_chunk_cluster_e5(P, E, tok_bytes, R, cluster, layout);
#endif
  *layout = -1;
  if (P <= 0 || R <= 0 || cluster < 0 || E != kFormE ||
      (tok_bytes != 2 && tok_bytes != 4))
    return (int)cudaSuccess;
  sst::Plan pl;
  bool ok = false;
  const int err = dispatch_form(E, tok_bytes, [&](auto e, auto tk) {
    using Family = ChunkKernels<decltype(e)::value, decltype(tk)>;
    return (int)sst::plan_for<Family>(P, E, cluster, &pl, &ok,
                                      kChunkRankPhones, R);
  });
  if (err == 0 && ok) *layout = pl.layout == sst::kHbm ? 0 : pl.cs;
  return err;
}

// cluster: the layout sst_viterbi_chunk_cluster returned (0: global
// memory, with anext).
extern "C" int SST_VIT_CHUNK(SST_VIT_CHUNK_PARAMS) {
#ifndef SST_VIT_E5
  if (E == 5)
    return sst_viterbi_chunk_e5(sen, t0, n, n_rows, tp, pred_idx, pred_pen,
                                tp_t, pred_idx_t, pred_pen_t, pred_n, astart,
                                aend, score, hist, osc, ohi,
                                best_prev, R, C, P, E, K, tok, tok_bytes, fin,
                                n_fin, path, fscore, anext, cluster, stream);
#endif
  if (P <= 0 || K <= 0 || cluster < 0 || (fin != nullptr && n_fin <= 0))
    return (int)cudaErrorInvalidValue;
  if (C <= 0 || R <= 0) return (int)cudaSuccess;
  const int32_t* const tables[6] = {tp,   pred_idx,   pred_pen,
                                     tp_t, pred_idx_t, pred_pen_t};
  return dispatch_form(E, tok_bytes, [&](auto e, auto tk) {
    constexpr int kE = decltype(e)::value;
    using Family = ChunkKernels<kE, decltype(tk)>;
    sst::Plan pl;
    if (cluster == 0) {
      pl = sst::one_block(P, kE);
      if (pl.layout != sst::kHbm) return (int)cudaErrorInvalidValue;
    } else {
      bool ok = false;
      const cudaError_t err = sst::plan_for<Family>(P, kE, cluster, &pl, &ok);
      if (err != cudaSuccess) return (int)err;
      if (!ok || pl.layout == sst::kHbm) return (int)cudaErrorInvalidValue;
    }
    if ((pl.layout == sst::kHbm) != (anext != nullptr))
      return (int)cudaErrorInvalidValue;
    // register-held phones read the [P, ...] tables, the others the
    // slot-major copies
    const Graph g = graph(tables, pred_n, astart, aend, P, kE, K,
                          pl.ph == 0);
    const ChunkArgs args{sen,   t0,    n,     n_rows, g,      score,
                         hist,  osc,   ohi,   best_prev, C,   P,
                         K,     pl.Pr, pl.hcap, tok,  fin,    n_fin,
                         path,  fscore, anext};
    return sst::with_kernel<Family>(pl, [&](auto kernel) {
      return sst::launch(kernel, pl, R, stream, args);
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
    return sst_viterbi_batch_e5(sen, n_frames, tp, pred_idx, pred_pen, tp_t,
                                pred_idx_t, pred_pen_t, pred_n, astart, aend,
                                entry, fin, B, T, P, E,
                                K, n_fin, tok, tok_bytes, tsc, path, pscore,
                                fscore, gstate, stream);
#endif
  if (P <= 0 || K <= 0 || n_fin <= 0) return (int)cudaErrorInvalidValue;
  const bool scores = tsc != nullptr;
  if (scores != (pscore != nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const bool global = gstate != nullptr;
  const int threads = sst::vit_threads(P);
  const int32_t* const tables[6] = {tp,   pred_idx,   pred_pen,
                                     tp_t, pred_idx_t, pred_pen_t};
  return dispatch_form(E, tok_bytes, [&](auto e, auto tk) {
    constexpr int kE = decltype(e)::value;
    using Tok = decltype(tk);
    return dispatch_bool(scores, [&](auto s) {
      return dispatch_layout<Tok>(global, P, E, threads,
                                  [&](auto gl, auto ph, auto pf) {
        constexpr bool kG = decltype(gl)::value;
        constexpr bool kP = decltype(pf)::value;
        constexpr int kPh = decltype(ph)::value;
        auto kernel = viterbi_kernel<kE, Tok, kG, decltype(s)::value, kPh, kP>;
        const Graph g = graph(tables, pred_n, astart, aend, P, kE, K,
                              kPh == 0);
        const size_t smem = kP ? sst::smem_bytes_prefetch(P, kE)
                               : sst::smem_bytes(P, kE, kG);
        const cudaError_t err = sst::allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<B, threads, smem, stream>>>(
            sen, n_frames, g, entry, fin, T, P, K, n_fin,
            static_cast<Tok*>(tok), tsc, static_cast<Tok*>(path), pscore,
            fscore, gstate);
        return (int)cudaGetLastError();
      });
    });
  });
}
