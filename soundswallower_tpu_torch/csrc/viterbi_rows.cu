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
#include <cooperative_groups.h>

#include <type_traits>

#include "viterbi_step.h"

#ifdef SST_VIT_E5
#define SST_VIT_ROWS sst_viterbi_rows_e5
#define SST_VIT_ROWS_CLUSTER sst_viterbi_rows_cluster_e5
#else
#define SST_VIT_ROWS sst_viterbi_rows
#define SST_VIT_ROWS_CLUSTER sst_viterbi_rows_cluster
#endif

namespace cg = cooperative_groups;

namespace {

using sst::dispatch_bool;
using sst::kMaxSmemBytes;
using sst::kMissing;
using sst::kRegSlots;
using sst::kWorst;

#ifdef SST_VIT_E5
constexpr int kFormE = 5;
#else
constexpr int kFormE = 3;
#endif

// the largest cluster (16 needs cudaFuncAttributeNonPortableClusterSizeAllowed)
constexpr int kMaxCluster = 16;
// in a cluster, a phone of more predecessors than this is weighed by a
// whole warp (there its predecessors are mostly other ranks', a
// distributed shared memory round trip each; one block reads its own
// shared memory, where the serial loop measured faster, and keeps it)
constexpr int kHeavyN = 8;
// such phones a block holds (more are weighed by their thread)
constexpr int kHeavyCap = 64;

// Where the row's state lives: one block's shared memory, the shared
// memories of a cluster's blocks, or a global scratch.
enum Layout : int { kBlock = 0, kCluster = 1, kHbm = 2 };

// The block's head of dynamic shared memory, in int32 slots: 32 warp
// maxima (after the frame loop, the rank's final candidate: score, node,
// out_hist) and, in a cluster, the block max and (8-byte aligned) the
// generic address of every rank's shared memory.  The state follows
// (16-byte aligned), then the two prefetch rows.  One block's head is
// the 128 bytes K4's is, so the same 7,040 phones of 3 states (4,741 of
// 5) fit it.
constexpr int kWmax = 0;
constexpr int kFsel = 0;
constexpr int kBmax = 32;
constexpr int kRbase = 34;

__host__ __device__ constexpr int head_ints(int layout) {
  return layout == kCluster ? (kRbase + 2 * kMaxCluster + 3) / 4 * 4 : 32;
}

// The heavy phones' table after the prefetch rows, in int32 slots: the
// count (then 3 of padding), the phones [hcap], their results (score,
// out_hist, ok) [hcap][3].
__host__ __device__ inline int heavy_ints(int hcap) {
  return hcap > 0 ? 4 + 4 * hcap : 0;
}

__host__ __device__ inline size_t rows_smem(int Pr, int E, int layout,
                                            bool pf, int hcap) {
  size_t b = head_ints(layout) * sizeof(int32_t);
  if (layout != kHbm) b += sst::state_bytes(Pr, E);
  if (pf) b += 2 * (size_t)E * Pr * sizeof(int32_t);
  return b + heavy_ints(hcap) * sizeof(int32_t);
}

// A predecessor of another rank through distributed shared memory: rank
// src / Pr, at the same offsets in its state as this rank's arrays.
struct ClusterNodes {
  const int32_t* osc;
  const int32_t* ohi;
  const uint8_t* anext;
  int lo, Pr;
  const char* const* rbase;  // [cluster size]: each rank's shared memory
  int off_osc, off_ohi, off_anext;  // bytes from its start
  __device__ __forceinline__ sst::NodeRef ref(int src) const {
    const unsigned loc = (unsigned)(src - lo);
    if (loc < (unsigned)Pr) return sst::NodeRef{osc + loc, ohi + loc, anext + loc};
    const int r = src / Pr;
    const int l = src - r * Pr;
    const char* base = rbase[r];
    return sst::NodeRef{
        reinterpret_cast<const int32_t*>(base + off_osc) + l,
        reinterpret_cast<const int32_t*>(base + off_ohi) + l,
        reinterpret_cast<const uint8_t*>(base + off_anext) + l};
  }
};

// One phone's constants: from registers (kPh > 0: the j-th phone of the
// thread) or loaded now.
template <int E, int kPh>
struct Consts {
  static constexpr int KR = kPh > 0 ? kRegSlots : 0;
  using Phone = sst::PhoneConsts<E, KR>;
  Phone reg[kPh > 0 ? kPh : 1];

  __device__ __forceinline__ void init(const sst::VitGraph& g, int lo,
                                       int np) {
    if (kPh > 0)
      sst::for_phones<kPh>(np, [&](int p, int j) {
        reg[j] = sst::load_phone<E, KR>(g, lo + p);
      });
  }
  __device__ __forceinline__ Phone get(const sst::VitGraph& g, int gp,
                                       int j) const {
    if (kPh > 0) return reg[j];
    return sst::load_phone<E, KR>(g, gp);
  }
};

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

template <int kLay>
__device__ __forceinline__ void row_sync() {
  if (kLay == kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

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

  int32_t* const wmax = sm + kWmax;
  char* const sbase = reinterpret_cast<char*>(sm + head_ints(kLay));
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
  const char** const rbase =
      kLay == kCluster ? reinterpret_cast<const char**>(sm + kRbase) : nullptr;
  if (kLay == kCluster && tid < CS)
    rbase[tid] = reinterpret_cast<const char*>(
        cg::this_cluster().map_shared_rank(reinterpret_cast<char*>(sm), tid));

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

  Consts<E, kPh> kc;
  kc.init(g, lo, np);
  // in a cluster, phones of more than kHeavyN predecessors, each weighed
  // by a warp: their slot in the block's table, or -1
  constexpr bool kHeavy = kLay == kCluster && kPh > 0;
  int32_t* const heavy = sbuf + (kPf ? 2 * E * Pr : 0);
  int hslot[kHeavy ? kPh : 1];
#pragma unroll
  for (int j = 0; j < (kHeavy ? kPh : 1); ++j) hslot[j] = -1;
  if (kHeavy && a.hcap > 0) {
    if (tid == 0) heavy[0] = 0;
    __syncthreads();
    sst::for_phones<kPh>(np, [&](int p, int j) {
      if (kc.reg[j].np > kHeavyN) {
        const int h = atomicAdd(heavy, 1);
        if (h < a.hcap) {
          heavy[4 + h] = p;
          hslot[j] = h;
        }
      }
    });
  }
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
  const auto nodes = [&] {
    if constexpr (kLay == kCluster) {
      const char* s0 = reinterpret_cast<const char*>(sm);
      return ClusterNodes{osc,
                          ohi,
                          anext,
                          lo,
                          Pr,
                          rbase,
                          (int)(reinterpret_cast<const char*>(osc) - s0),
                          (int)(reinterpret_cast<const char*>(ohi) - s0),
                          (int)(reinterpret_cast<const char*>(anext) - s0)};
    } else {
      return sst::LocalNodes{osc, ohi, anext};
    }
  }();
  int32_t best_prev = 0;
  // every block of the cluster runs (and its rbase is written) before a
  // rank reads another's shared memory
  row_sync<kLay>();
  const int n_heavy = kHeavy && a.hcap > 0 ? min(heavy[0], a.hcap) : 0;
  int32_t* const hres = heavy + 4 + a.hcap;  // [hcap][3]

  for (int t = 0; t < T; ++t) {
    const size_t row_t = ((size_t)b * T + t) * S;
    const int32_t* sen_t =
        kPf ? sbuf + (t & 1) * E * Pr : sen_r + (size_t)t * S;
    if (kPf && t + 1 < T)
      sst::prefetch_row(sbuf + ((t + 1) & 1) * E * Pr,
                        sen_r + (size_t)(t + 1) * S, E * np);
    if (kLay == kCluster && t > 0) {
      // the cluster's best of the previous frame: each rank's block max,
      // written before the previous frame's last barrier
      int32_t m = kWorst;
      for (int r = 0; r < CS; ++r)
        m = max(m, reinterpret_cast<const int32_t*>(rbase[r])[kBmax]);
      best_prev = m;
    }
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
    lbest = __reduce_max_sync(0xffffffffu, lbest);
    if ((tid & 31) == 0) wmax[tid >> 5] = lbest;
    row_sync<kLay>();
    // the block's best over active phones
    const int lane = tid & 31;
    const int32_t best = __reduce_max_sync(
        0xffffffffu, lane < (nthr >> 5) ? wmax[lane] : kWorst);
    if (kLay == kCluster && tid == 0) sm[kBmax] = best;

    // -- the heavy phones' predecessor max, a warp each: each lane the
    // first max of its slots (lane, lane + 32, ...) with the strict `>`
    // from WORST, then the warp's max and the lowest slot holding it, so
    // the result is the serial loop's (enter_strict_at) --
    if (kHeavy && n_heavy > 0) {
      const int warp = tid >> 5;
      for (int h = warp; h < n_heavy; h += nthr >> 5) {
        const int gp = lo + heavy[4 + h];
        const int nin = g.pred_n[gp];
        const int32_t* const pi = g.pred_idx + (size_t)gp * K;
        const int32_t* const pp = g.pred_pen + (size_t)gp * K;
        int32_t lv = kWorst;
        int lk = INT_MAX;
        for (int k = lane; k < nin; k += 32) {
          const sst::NodeRef r = nodes.ref(pi[k]);
          const bool ok = *r.anext;
          const int32_t val = ok ? sst::wadd(*r.osc, pp[k]) : kWorst;
          if (val > lv) {
            lv = val;
            lk = k;
          }
        }
        const int32_t m = __reduce_max_sync(0xffffffffu, lv);
        const int kmin =
            __reduce_min_sync(0xffffffffu, lv == m ? lk : INT_MAX);
        int32_t eh = -1;
        if (kmin != INT_MAX && (kmin & 31) == lane)
          eh = *nodes.ref(pi[kmin]).ohi;
        eh = __shfl_sync(0xffffffffu, eh, kmin & 31);
        if (lane == 0) {
          hres[3 * h] = m;
          hres[3 * h + 1] = kmin != INT_MAX ? eh : -1;
          hres[3 * h + 2] = kmin != INT_MAX;
        }
      }
      __syncthreads();
    }

    // -- phone transitions, entries and token record --
    const int nf = t + 1;
    sst::for_phones<kPh>(np, [&](int p, int j) {
      const int gp = lo + p;
      const auto c = kc.get(g, gp, j);
      using KC = Consts<E, kPh>;
      int32_t es, eh;
      bool eok;
      const size_t at = (size_t)gp * K;
      if (kHeavy && hslot[j] >= 0) {
        es = hres[3 * hslot[j]];
        eh = hres[3 * hslot[j] + 1];
        eok = hres[3 * hslot[j] + 2] != 0;
      } else {
        sst::enter_strict_at<KC::KR>(c.np, c.src, c.pen, g.pred_idx + at,
                                     g.pred_pen + at, 1, nodes, &es, &eh,
                                     &eok);
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
    row_sync<kLay>();
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
    row_sync<kLay>();
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
  if (kLay == kCluster) row_sync<kLay>();
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

template <int V>
using IC = std::integral_constant<int, V>;

// One launch's plan: the layout, the cluster size (1 outside the
// cluster layout), phones a rank, threads a block, phones a thread in
// registers (0: loaded at each use) and the prefetch.
struct Plan {
  int layout, cs, Pr, threads, ph;
  bool pf;
  int hcap;
  size_t smem;
};

// The plan of a cluster of cs blocks, or of one block (cs = 1): each
// thread at most two phones in registers, the state and two prefetch
// rows in the rank's shared memory; false where they do not fit.
bool fits(int P, int E, int cs, Plan* pl) {
  const int Pr = (P + cs - 1) / cs;
  const int threads = sst::vit_threads(Pr);
  const int ph = sst::vit_reg_phones(Pr, threads);
  const int layout = cs > 1 ? kCluster : kBlock;
  const int hcap = layout == kCluster ? kHeavyCap : 0;
  const size_t smem = rows_smem(Pr, E, layout, true, hcap);
  if (ph == 0 || smem > kMaxSmemBytes) return false;
  *pl = Plan{layout, cs, Pr, threads, ph, true, hcap, smem};
  return true;
}

// One block a row: registers and prefetch where fits() allows, else the
// state alone in shared memory where it fits, else in the global scratch.
Plan one_block(int P, int E) {
  Plan pl;
  if (fits(P, E, 1, &pl)) return pl;
  const int threads = sst::vit_threads(P);
  const int ph = sst::vit_reg_phones(P, threads);
  if (rows_smem(P, E, kBlock, false, 0) <= kMaxSmemBytes)
    return Plan{kBlock, 1, P, threads, ph, false, 0,
                rows_smem(P, E, kBlock, false, 0)};
  return Plan{kHbm, 1, P, threads, 0, false, 0,
              rows_smem(P, E, kHbm, false, 0)};
}

// Calls f(kernel) with the kernel instance of a plan.
template <int E, typename Tok, bool kScores, typename F>
int with_kernel(const Plan& pl, F&& f) {
  if (pl.layout == kHbm)
    return f(viterbi_rows_kernel<E, Tok, kScores, kHbm, 0, false>);
  if (pl.layout == kCluster) {
    if (pl.ph == 1) return f(viterbi_rows_kernel<E, Tok, kScores, kCluster, 1, true>);
    return f(viterbi_rows_kernel<E, Tok, kScores, kCluster, 2, true>);
  }
  if constexpr (!std::is_same<Tok, int16_t>::value) {
    // S >= 32767 (int32 tokens) never fits one block's shared memory
    return (int)cudaErrorInvalidValue;
  } else {
    if (pl.ph == 0) return f(viterbi_rows_kernel<E, Tok, kScores, kBlock, 0, false>);
    if (pl.ph == 1) {
      if (pl.pf) return f(viterbi_rows_kernel<E, Tok, kScores, kBlock, 1, true>);
      return f(viterbi_rows_kernel<E, Tok, kScores, kBlock, 1, false>);
    }
    if (pl.pf) return f(viterbi_rows_kernel<E, Tok, kScores, kBlock, 2, true>);
    return f(viterbi_rows_kernel<E, Tok, kScores, kBlock, 2, false>);
  }
}

// The kernel's attributes for a plan: its shared memory and, for a
// cluster of more than 8 blocks, the non-portable size.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Plan& pl) {
  cudaError_t err = sst::allow_smem(kernel, pl.smem);
  if (err == cudaSuccess && pl.cs > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(const Plan& pl, int B,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * pl.cs));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)pl.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether at least one cluster of the plan can be resident on the card
// (cudaOccupancyMaxActiveClusters reports one or more), in *ok; true
// outside the cluster layout.  A CUDA error of the kernel's attributes
// or of the query is returned, not taken for a size that cannot run.
template <int E, typename Tok, bool kScores>
cudaError_t launchable(const Plan& pl, bool* ok) {
  *ok = true;
  if (pl.layout != kCluster) return cudaSuccess;
  int active = 0;
  const int err = with_kernel<E, Tok, kScores>(pl, [&](auto kernel) {
    cudaError_t e = prepare(kernel, pl);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(pl, 1, &attr, 0);
    return (int)cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  });
  *ok = err == cudaSuccess && active > 0;
  if (err != cudaSuccess) cudaGetLastError();  // reported here, not later
  return (cudaError_t)err;
}

// The plan for P phones: `cluster` blocks a row as asked (1: one block,
// the state in shared or, where it does not fit, in global memory), or,
// cluster 0, the smallest of one block and clusters of 2, 4, 8 and 16
// that holds each thread's phones in registers with the prefetch and can
// be resident; past those, one block with the state in global memory.
// *ok false where the asked cluster does not fit or cannot run; a CUDA
// error of launchable() is returned.
template <int E, typename Tok, bool kScores>
cudaError_t plan_for(int P, int cluster, Plan* pl, bool* ok) {
  *ok = true;
  if (cluster == 1) {
    *pl = one_block(P, E);
    return cudaSuccess;
  }
  if (cluster > 1) {
    *ok = cluster <= kMaxCluster && fits(P, E, cluster, pl);
    return *ok ? launchable<E, Tok, kScores>(*pl, ok) : cudaSuccess;
  }
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    if (!fits(P, E, cs, pl)) continue;
    const cudaError_t err = launchable<E, Tok, kScores>(*pl, ok);
    if (err != cudaSuccess || *ok) return err;
  }
  *ok = true;
  *pl = one_block(P, E);
  return cudaSuccess;
}

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
  Plan pl;
  bool ok = false;
  const int err = dispatch_form(E, tok_bytes, scores != 0,
                                [&](auto e, auto tk, auto s) {
    return (int)plan_for<decltype(e)::value, decltype(tk),
                         decltype(s)::value>(P, cluster, &pl, &ok);
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
    constexpr bool kS = decltype(s)::value;
    Plan pl;
    // cluster 0 here means the global-state layout that
    // sst_viterbi_rows_cluster returned as 0
    if (cluster == 0) {
      pl = one_block(P, kE);
      if (pl.layout != kHbm) return (int)cudaErrorInvalidValue;
    } else {
      bool ok = false;
      const cudaError_t err = plan_for<kE, Tok, kS>(P, cluster, &pl, &ok);
      if (err != cudaSuccess) return (int)err;
      if (!ok || pl.layout == kHbm) return (int)cudaErrorInvalidValue;
    }
    if ((pl.layout == kHbm) != (gstate != nullptr))
      return (int)cudaErrorInvalidValue;
    const RowArgs args{sen,    n_frames, tp,    src,    pen,    nin,
                       astart, aend,     entry, final_mask, T,  P,
                       K,      pl.Pr,    pl.hcap, tok,  tsc,    path,
                       pscore, fscore,   gstate};
    return with_kernel<kE, Tok, kS>(pl, [&](auto kernel) {
      const cudaError_t err = prepare(kernel, pl);
      if (err != cudaSuccess) return (int)err;
      if (pl.layout == kCluster) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(pl, B, &attr, stream);
        const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
        if (e != cudaSuccess) return (int)e;
      } else {
        kernel<<<B, pl.threads, pl.smem, stream>>>(args);
      }
      return (int)cudaGetLastError();
    });
  });
}
