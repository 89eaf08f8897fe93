// The per-phone frame step shared by the Viterbi kernels K4
// (viterbi.cu) and K6 (viterbi_rows.cu): XLA's wrapping int32 adds, the
// layouts of a row's Viterbi state (one block's shared memory, a
// thread-block cluster's, or a global scratch) and the plan that picks
// one, hmm.c's 3- and 5-state updates (align_jax.py _eval_3st_lanes,
// _eval_5st) with the renormalization rule, and the predecessor max.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <type_traits>

#include "sst_kernels.h"

namespace cg = cooperative_groups;

namespace sst {

constexpr int32_t kWorst = SST_WORST_SCORE;
constexpr int32_t kMissing = -(1 << 30);  // backtrace_batch's masked-max floor
// dynamic shared memory a Hopper block can use
constexpr size_t kMaxSmemBytes = 232448;
// predecessor slots held in registers beside a phone's constants
constexpr int kRegSlots = 2;

// f(true_type) or f(false_type): a runtime flag as a template argument
template <typename F>
int dispatch_bool(bool x, F&& f) {
  return x ? f(std::true_type{}) : f(std::false_type{});
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// A row's Viterbi state: score, hist [P, E], out_score, out_hist [P]
// (int32), then active_next [P] (bytes), rounded up to 16 bytes.
__host__ __device__ inline size_t state_bytes(int P, int E) {
  const size_t b = (size_t)(2 * E * P + 2 * P) * sizeof(int32_t) + (size_t)P;
  return (b + 15) / 16 * 16;
}

// Dynamic shared memory of a block: 32 warp maxima, then, in the
// shared layout, the row's state.
__host__ __device__ inline size_t smem_bytes(int P, int E, bool global) {
  return 32 * sizeof(int32_t) + (global ? 0 : state_bytes(P, E));
}

struct VitState {
  int32_t* score;  // [P, E]
  int32_t* hist;   // [P, E]
  int32_t* osc;    // [P] out_score
  int32_t* ohi;    // [P] out_hist
  uint8_t* anext;  // [P] active in the next frame
};

// The state at `base` (shared memory, or the row's slice of the global
// scratch; one block owns it either way, and __syncthreads orders its
// reads and writes in both).
__device__ __forceinline__ VitState carve(void* base, int P, int E) {
  VitState v;
  v.score = reinterpret_cast<int32_t*>(base);
  v.hist = v.score + E * P;
  v.osc = v.hist + E * P;
  v.ohi = v.osc + P;
  v.anext = reinterpret_cast<uint8_t*>(v.ohi + P);
  return v;
}

// Frame update of phone p: renormalizes its scores when the previous
// frame's best crossed the threshold and, when the phone is active, runs
// the E-state update (reading the row's senone scores sen [E] and the
// negated tmat tq [E, E+1]), writing out_score/out_hist when the exit
// state is reached.  Returns the phone's best new score (kWorst when
// inactive).
template <int E>
__device__ int32_t hmm_update(int32_t* score, int32_t* hist, int32_t* osc,
                              int32_t* ohi, const int32_t* __restrict__ tq,
                              const int32_t* __restrict__ sen, bool act,
                              bool renorm, int32_t best_prev);

// 3 states (_eval_3st_lanes), with hmm.c's reuse of t2 when the 0->2
// skip is absent
template <>
__device__ __forceinline__ int32_t hmm_update<3>(
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

// sel3 of _eval_5st: C's nested `if t0 > t1 (t2 > t0 ? t2 : t0) else
// (t2 > t1 ? t2 : t1)`, strict, with the history of the branch taken,
// then the WORST clamp.
__device__ __forceinline__ void sel3(int32_t t0, int32_t t1, int32_t t2,
                                     int32_t h0, int32_t h1, int32_t h2,
                                     int32_t* ns, int32_t* nh) {
  const bool br = t0 > t1;
  const bool use2 = br ? t2 > t0 : t2 > t1;
  *ns = max(use2 ? t2 : (br ? t0 : t1), kWorst);
  *nh = use2 ? h2 : (br ? h0 : h1);
}

// 5 states (_eval_5st): every 3-way select reads its own transition row
// (no t2 reuse); the exit (state 5) is written when s3 > WORST, state 4
// is updated when s2 > WORST and state 3 when s1 > WORST, else they keep
// their (renormalized) score and history.
template <>
__device__ __forceinline__ int32_t hmm_update<5>(
    int32_t* score, int32_t* hist, int32_t* osc, int32_t* ohi,
    const int32_t* __restrict__ tq, const int32_t* __restrict__ sen5,
    bool act, bool renorm, int32_t best_prev) {
  int32_t sc[5], h[5], s[5];
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    sc[e] = score[e];
    if (renorm && sc[e] > kWorst) sc[e] = wsub(sc[e], best_prev);
    h[e] = hist[e];
    s[e] = wsub(sc[e], sen5[e]);
  }
  // s[i] + tprob(i, j) = s[i] - tq[6 * i + j]
#define SST_T5(i, j) wsub(s[i], tq[6 * (i) + (j)])
  int32_t bst = kWorst;
  // state 5 (non-emitting exit) from 4 and 3
  const int32_t x1 = SST_T5(4, 5), x2 = SST_T5(3, 5);
  if (act && s[3] > kWorst) {
    const int32_t s5 = max(x1 > x2 ? x1 : x2, kWorst);
    *osc = s5;
    *ohi = x1 > x2 ? h[4] : h[3];
    bst = s5;
  }
  int32_t ns4, nh4, ns3, nh3, ns2, nh2;
  const bool g4 = act && s[2] > kWorst;
  sel3(SST_T5(4, 4), SST_T5(3, 4), SST_T5(2, 4), h[4], h[3], h[2], &ns4,
       &nh4);
  const bool g3 = act && s[1] > kWorst;
  sel3(SST_T5(3, 3), SST_T5(2, 3), SST_T5(1, 3), h[3], h[2], h[1], &ns3,
       &nh3);
  sel3(SST_T5(2, 2), SST_T5(1, 2), SST_T5(0, 2), h[2], h[1], h[0], &ns2,
       &nh2);
  const int32_t b0 = SST_T5(1, 1), b1 = SST_T5(0, 1);
  const int32_t ns1 = max(b0 > b1 ? b0 : b1, kWorst);
  const int32_t nh1 = b0 > b1 ? h[1] : h[0];
  const int32_t ns0 = max(SST_T5(0, 0), kWorst);
#undef SST_T5
  if (g4) {
    bst = max(bst, ns4);
    sc[4] = ns4;
    hist[4] = nh4;
  }
  if (g3) {
    bst = max(bst, ns3);
    sc[3] = ns3;
    hist[3] = nh3;
  }
  if (act) {
    bst = max(bst, max(ns2, max(ns1, ns0)));
    sc[2] = ns2;
    sc[1] = ns1;
    sc[0] = ns0;
    hist[2] = nh2;
    hist[1] = nh1;
  }
#pragma unroll
  for (int e = 0; e < 5; ++e) score[e] = sc[e];
  return bst;
}

// -- the bounded edge loop (K4, its carry form, K6) ---------------------------
//
// A phone's real predecessor slots are a prefix of its K slots (slots
// fill in edge order from 0; align_torch.pred_count checks it), so
// slots 0 .. n-1 hold the edges (pred_ok true) and n .. K-1 padding
// whose value is WORST_SCORE (pred_ok false).  The loops below visit the
// n real slots and never read pred_ok.  K6's band form hands them its
// band slots with band_ok as such a list (align_torch.band_lists).  The
// first KR slots may come from registers (src/pen), the others from the
// phone's slots pi/pp, slot k at pi[k * ks] (ks 1 in the [P, K] tables,
// P in slot-major [K, P] ones).

// Where a predecessor's out_score, out_hist and active_next live: a
// NodeRef of three pointers, from a Nodes policy's ref(src).  LocalNodes
// are one block's arrays (or the row's global scratch); ClusterNodes
// (below) map a phone of another block of a cluster into that block's
// shared memory.
struct NodeRef {
  const int32_t* osc;
  const int32_t* ohi;
  const uint8_t* anext;
};

struct LocalNodes {
  const int32_t* osc;
  const int32_t* ohi;
  const uint8_t* anext;
  __device__ __forceinline__ NodeRef ref(int src) const {
    return NodeRef{osc + src, ohi + src, anext + src};
  }
};

// K4's and K6's rule: strict `>` from WORST_SCORE, so a padded slot
// never wins and the loop stops at n.
template <int KR, typename Nodes>
__device__ __forceinline__ void enter_strict_at(
    int n, const int32_t* src_r, const int32_t* pen_r,
    const int32_t* __restrict__ pi, const int32_t* __restrict__ pp, int ks,
    const Nodes& nodes, int32_t* es, int32_t* eh, bool* eok) {
  int32_t s = kWorst, h = -1;
  bool o = false;
  auto slot = [&](int src, int32_t pen) {
    const NodeRef r = nodes.ref(src);
    const bool ok = *r.anext;
    const int32_t val = ok ? wadd(*r.osc, pen) : kWorst;
    if (val > s) {  // strict: the first slot wins ties
      s = val;
      h = *r.ohi;
      o = ok;
    }
  };
#pragma unroll
  for (int k = 0; k < KR; ++k)
    if (k < n) slot(src_r[k], pen_r[k]);
  for (int k = KR; k < n; ++k) slot(pi[k * ks], pp[k * ks]);
  *es = s;
  *eh = o ? h : -1;
  *eok = o;
}

// The carry form's rule, jnp.argmax over the K slots: slot 0 is taken
// whatever its value, a later slot where it is strictly greater.  After
// the n real slots, the first padded slot (value WORST_SCORE, not ok)
// is one more candidate when n < K: it wins where n == 0 or where every
// real slot fell below WORST_SCORE, and later padded slots tie it.
template <int KR, typename Nodes>
__device__ __forceinline__ void enter_argmax(
    int n, int K, const int32_t* src_r, const int32_t* pen_r,
    const int32_t* __restrict__ pi, const int32_t* __restrict__ pp, int ks,
    const Nodes& nodes, int32_t* es, int32_t* eh, bool* eok) {
  int32_t s = kWorst, h = -1;
  bool o = false;
  auto slot = [&](int k, int src, int32_t pen) {
    const NodeRef r = nodes.ref(src);
    const bool ok = *r.anext;
    const int32_t val = ok ? wadd(*r.osc, pen) : kWorst;
    if (k == 0 || val > s) {
      s = val;
      h = *r.ohi;
      o = ok;
    }
  };
#pragma unroll
  for (int k = 0; k < KR; ++k)
    if (k < n) slot(k, src_r[k], pen_r[k]);
  for (int k = KR; k < n; ++k) slot(k, pi[k * ks], pp[k * ks]);
  if (n < K && (n == 0 || kWorst > s)) {
    s = kWorst;
    o = false;
  }
  *es = s;
  *eh = o ? h : -1;
  *eok = o;
}

// -- the frame step's constants and scores (K4 and its carry form) -----------

// K4's graph tables as its frame step reads them: entry i of phone p's
// negated tmat row at tp[p * tq_p + i * tq_i] and its slot k at
// pred_idx/pred_pen[p * k_p + k * k_k]; phone-major ([P, E*(E+1)],
// [P, K]: tq_p = E*(E+1), k_p = K, the others 1) or slot-major
// ([E*(E+1), P], [K, P]: tq_i = k_k = P, the others 1), where a warp's
// 32 phones read one 128-byte line per entry or slot instead of 32.
struct VitGraph {
  const int32_t* __restrict__ tp;
  const int32_t* __restrict__ pred_idx;
  const int32_t* __restrict__ pred_pen;
  const int32_t* __restrict__ pred_n;
  const int32_t* __restrict__ astart;
  const int32_t* __restrict__ aend;
  int tq_p, tq_i, k_p, k_k;
};

// What one phone's frame step reads of the graph, whatever the frame:
// its negated tmat row, its active window, its in-degree and its first
// KR predecessor slots.  Held in registers across the frame loop where a
// thread owns at most two phones; loaded at each use elsewhere (the
// compiler drops the loads of the tq entries the update never reads).
template <int E, int KR>
struct PhoneConsts {
  int32_t tq[E * (E + 1)];
  int32_t ast, aen, np;
  int32_t src[KR > 0 ? KR : 1], pen[KR > 0 ? KR : 1];
};

template <int E, int KR>
__device__ __forceinline__ PhoneConsts<E, KR> load_phone(const VitGraph& g,
                                                         int p) {
  PhoneConsts<E, KR> c;
#pragma unroll
  for (int i = 0; i < E * (E + 1); ++i)
    c.tq[i] = g.tp[(size_t)p * g.tq_p + (size_t)i * g.tq_i];
  c.ast = g.astart[p];
  c.aen = g.aend[p];
  c.np = g.pred_n[p];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const size_t at = (size_t)p * g.k_p + (size_t)k * g.k_k;
    c.src[k] = k < c.np ? g.pred_idx[at] : 0;
    c.pen[k] = k < c.np ? g.pred_pen[at] : 0;
  }
  return c;
}

// Calls f(p, j) for each phone p of this thread: p = tid + j * blockDim.x,
// j < kPh (unrolled, so that a register array indexed by j stays in
// registers), or, kPh == 0, every such p below P (j = 0).
template <int kPh, typename F>
__device__ __forceinline__ void for_phones(int P, F&& f) {
  if (kPh == 0) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) f(p, 0);
  } else {
#pragma unroll
    for (int j = 0; j < (kPh > 0 ? kPh : 1); ++j) {
      const int p = threadIdx.x + j * blockDim.x;
      if (p < P) f(p, j);
    }
  }
}

// Phones a thread holds in registers: 1 or 2 where the block's threads
// cover P that many times, else 0 (loaded at each use).
inline int vit_reg_phones(int P, int threads) {
  return P <= threads ? 1 : (P <= 2 * threads ? 2 : 0);
}

// The next frame's S senone scores, copied into shared memory with
// 4-byte cp.async (rows of S int32 start off a 16-byte boundary at every
// other frame where S % 4 != 0); cp_async_wait_all, then a barrier,
// makes them visible to the block.
__device__ __forceinline__ void prefetch_row(int32_t* dst,
                                            const int32_t* __restrict__ src,
                                            int S) {
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory with the two prefetch rows of S int32 after the
// shared-layout state.
__host__ __device__ inline size_t smem_bytes_prefetch(int P, int E) {
  return smem_bytes(P, E, false) + 2 * (size_t)E * P * sizeof(int32_t);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it
// needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int vit_threads(int P) { return P < 1024 ? (P + 31) / 32 * 32 : 1024; }

// The constants of this thread's phones lo + p (p < np): in registers
// (kPh > 0: the j-th phone of the thread) or loaded at each use.
template <int E, int kPh>
struct Consts {
  static constexpr int KR = kPh > 0 ? kRegSlots : 0;
  using Phone = PhoneConsts<E, KR>;
  Phone reg[kPh > 0 ? kPh : 1];

  __device__ __forceinline__ void init(const VitGraph& g, int lo, int np) {
    if (kPh > 0)
      for_phones<kPh>(np, [&](int p, int j) {
        reg[j] = load_phone<E, KR>(g, lo + p);
      });
  }
  __device__ __forceinline__ Phone get(const VitGraph& g, int gp,
                                       int j) const {
    if (kPh > 0) return reg[j];
    return load_phone<E, KR>(g, gp);
  }
  // Where phone gp's slots start and their stride: register-held phones
  // always get phone-major [P, K] tables, so theirs stay K and 1 without
  // reading the VitGraph's strides in the frame loop.
  __device__ __forceinline__ static size_t slots_at(const VitGraph& g, int K,
                                                    int gp) {
    return (size_t)gp * (kPh > 0 ? K : g.k_p);
  }
  __device__ __forceinline__ static int slot_stride(const VitGraph& g) {
    return kPh > 0 ? 1 : g.k_k;
  }
};

// -- the row's layouts: one block, a thread-block cluster, global memory -----
//
// A row (one utterance's frame recurrence) runs on one block or, past
// what one block holds at two phones a thread, on a cluster of 2-16
// blocks: rank r owns phones [r*Pr, r*Pr + Pr), their state in its own
// shared memory, and reads a predecessor of another rank through
// distributed shared memory (ClusterNodes); the frame's two block
// barriers become cluster barriers (row_sync) and the best score a
// cluster max (each rank's block max at kBmax, read by every rank at the
// next frame: cluster_best).  Only a graph past the largest cluster (or a
// launch asked for one block whose state does not fit it) keeps its
// state in a global scratch of state_bytes(P, E) a row.

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
// maxima (after K6's frame loop, the rank's final candidate: score,
// node, out_hist) and, in a cluster, the block max and (8-byte aligned)
// the generic address of every rank's shared memory.  The state follows
// (16-byte aligned), then the two prefetch rows, then the heavy phones'
// table.  One block's head is 128 bytes, so 7,040 phones of 3 states
// (4,741 of 5) fit it.
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

__host__ __device__ inline size_t row_smem(int Pr, int E, int layout,
                                           bool pf, int hcap) {
  size_t b = head_ints(layout) * sizeof(int32_t);
  if (layout != kHbm) b += state_bytes(Pr, E);
  if (pf) b += 2 * (size_t)E * Pr * sizeof(int32_t);
  return b + heavy_ints(hcap) * sizeof(int32_t);
}

template <int kLay>
__device__ __forceinline__ void row_sync() {
  if (kLay == kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// In a cluster, each rank's shared memory as a generic address, kept at
// sm + kRbase (read after the first row_sync); nullptr elsewhere.
template <int kLay>
__device__ __forceinline__ const char* const* rank_bases(int32_t* sm) {
  if (kLay != kCluster) return nullptr;
  const char** rb = reinterpret_cast<const char**>(sm + kRbase);
  if (threadIdx.x < cg::this_cluster().num_blocks())
    rb[threadIdx.x] = reinterpret_cast<const char*>(
        cg::this_cluster().map_shared_rank(reinterpret_cast<char*>(sm),
                                           threadIdx.x));
  return rb;
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
  __device__ __forceinline__ NodeRef ref(int src) const {
    const unsigned loc = (unsigned)(src - lo);
    if (loc < (unsigned)Pr) return NodeRef{osc + loc, ohi + loc, anext + loc};
    const int r = src / Pr;
    const int l = src - r * Pr;
    const char* base = rbase[r];
    return NodeRef{reinterpret_cast<const int32_t*>(base + off_osc) + l,
                   reinterpret_cast<const int32_t*>(base + off_ohi) + l,
                   reinterpret_cast<const uint8_t*>(base + off_anext) + l};
  }
};

// The Nodes policy of a layout: ClusterNodes over the ranks' shared
// memories (sm each), or the state's own arrays.
template <int kLay>
__device__ __forceinline__ auto row_nodes(const int32_t* sm,
                                          const VitState& v, int lo, int Pr,
                                          const char* const* rbase) {
  if constexpr (kLay == kCluster) {
    const char* s0 = reinterpret_cast<const char*>(sm);
    return ClusterNodes{v.osc,
                        v.ohi,
                        v.anext,
                        lo,
                        Pr,
                        rbase,
                        (int)(reinterpret_cast<const char*>(v.osc) - s0),
                        (int)(reinterpret_cast<const char*>(v.ohi) - s0),
                        (int)(reinterpret_cast<const char*>(v.anext) - s0)};
  } else {
    return LocalNodes{v.osc, v.ohi, v.anext};
  }
}

// The block's max of v over its threads, returned to every thread: each
// warp's max at sm[kWmax + warp], the layout's barrier, then one shared
// load a lane and a reduction.  In a cluster thread 0 also posts it at
// sm[kBmax] for cluster_best.  Needs a block of whole warps.
template <int kLay>
__device__ __forceinline__ int32_t row_block_max(int32_t v, int32_t* sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) sm[kWmax + (tid >> 5)] = v;
  row_sync<kLay>();
  const int32_t best = __reduce_max_sync(
      0xffffffffu, lane < (int)(blockDim.x >> 5) ? sm[kWmax + lane] : kWorst);
  if (kLay == kCluster && tid == 0) sm[kBmax] = best;
  return best;
}

// The cluster's best of the frame whose block maxima the ranks posted
// (row_block_max) before the last row_sync.
__device__ __forceinline__ int32_t cluster_best(const char* const* rbase,
                                                int CS) {
  int32_t m = kWorst;
  for (int r = 0; r < CS; ++r)
    m = max(m, reinterpret_cast<const int32_t*>(rbase[r])[kBmax]);
  return m;
}

// In a cluster, the phones of this thread with more than kHeavyN
// predecessors take a slot of the block's table at `heavy` (count, then
// phones [hcap]), up to hcap of them: hslot[j] their slot, else -1.
// The count is read after the next barrier.
template <int kPh, typename KC>
__device__ __forceinline__ void heavy_register(const KC& kc, int np,
                                               int hcap, int32_t* heavy,
                                               int* hslot) {
  if (threadIdx.x == 0) heavy[0] = 0;
  __syncthreads();
  for_phones<kPh>(np, [&](int p, int j) {
    if (kc.reg[j].np > kHeavyN) {
      const int h = atomicAdd(heavy, 1);
      if (h < hcap) {
        heavy[4 + h] = p;
        hslot[j] = h;
      }
    }
  });
}

// The heavy phones' predecessor max (phones lo + hph[h], phone-major
// [P, K] slots), a warp each: each lane the first max of its slots
// (lane, lane + 32, ...), then the warp's max and the lowest slot
// holding it, so the result is the serial loop's: enter_strict_at's
// (kArgmax false: strict `>` from WORST_SCORE, no slot where none passes
// it) or enter_argmax's (each lane's first slot taken whatever its
// value, and the first padded slot one more candidate).  Writes (score,
// out_hist, ok) [n_heavy][3] to hres; a __syncthreads makes them
// visible to the block.
template <bool kArgmax, typename Nodes>
__device__ __forceinline__ void weigh_heavy(int n_heavy,
                                            const int32_t* hph,
                                            int32_t* hres, int lo,
                                            const VitGraph& g, int K,
                                            const Nodes& nodes) {
  const int lane = threadIdx.x & 31;
  for (int h = threadIdx.x >> 5; h < n_heavy; h += blockDim.x >> 5) {
    const int gp = lo + hph[h];
    const int nin = g.pred_n[gp];
    const int32_t* const pi = g.pred_idx + (size_t)gp * K;
    const int32_t* const pp = g.pred_pen + (size_t)gp * K;
    int32_t lv = kArgmax ? INT_MIN : kWorst;
    int lk = INT_MAX;
    for (int k = lane; k < nin; k += 32) {
      const NodeRef r = nodes.ref(pi[k]);
      const bool ok = *r.anext;
      const int32_t val = ok ? wadd(*r.osc, pp[k]) : kWorst;
      if (val > lv || (kArgmax && lk == INT_MAX)) {
        lv = val;
        lk = k;
      }
    }
    const int32_t m = __reduce_max_sync(0xffffffffu, lv);
    const int kmin = __reduce_min_sync(0xffffffffu, lv == m ? lk : INT_MAX);
    int32_t eh = -1;
    int wok = 0;
    if (kmin != INT_MAX && (kmin & 31) == lane) {
      const NodeRef r = nodes.ref(pi[kmin]);
      eh = *r.ohi;
      if (kArgmax) wok = *r.anext;
    }
    eh = __shfl_sync(0xffffffffu, eh, kmin & 31);
    // the strict rule's winner passed WORST_SCORE, so its slot was active
    bool ok = kmin != INT_MAX;
    int32_t s = m;
    if (kArgmax) {
      ok = ok && __shfl_sync(0xffffffffu, wok, kmin & 31) != 0;
      if (nin < K && (nin == 0 || kWorst > m)) {
        s = kWorst;
        ok = false;
      }
    }
    if (lane == 0) {
      hres[3 * h] = s;
      hres[3 * h + 1] = ok ? eh : -1;
      hres[3 * h + 2] = ok;
    }
  }
}

// One launch's plan: the layout, the cluster size (1 outside the
// cluster layout), phones a rank, threads a block, phones a thread in
// registers (0: loaded at each use), the prefetch, the heavy phones a
// block holds and the dynamic shared memory.
struct Plan {
  int layout, cs, Pr, threads, ph;
  bool pf;
  int hcap;
  size_t smem;
};

// The plan of a cluster of cs blocks, or of one block (cs = 1): each
// thread at most two phones in registers, the state and two prefetch
// rows in the rank's shared memory; false where they do not fit.
inline bool fits(int P, int E, int cs, Plan* pl) {
  const int Pr = (P + cs - 1) / cs;
  const int threads = vit_threads(Pr);
  const int ph = vit_reg_phones(Pr, threads);
  const int layout = cs > 1 ? kCluster : kBlock;
  const int hcap = layout == kCluster ? kHeavyCap : 0;
  const size_t smem = row_smem(Pr, E, layout, true, hcap);
  if (ph == 0 || smem > kMaxSmemBytes) return false;
  *pl = Plan{layout, cs, Pr, threads, ph, true, hcap, smem};
  return true;
}

// One block a row: registers and prefetch where fits() allows, else the
// state alone in shared memory where it fits, else in the global scratch.
inline Plan one_block(int P, int E) {
  Plan pl;
  if (fits(P, E, 1, &pl)) return pl;
  const int threads = vit_threads(P);
  const int ph = vit_reg_phones(P, threads);
  if (row_smem(P, E, kBlock, false, 0) <= kMaxSmemBytes)
    return Plan{kBlock, 1, P, threads, ph, false, 0,
                row_smem(P, E, kBlock, false, 0)};
  return Plan{kHbm, 1, P, threads, 0, false, 0,
              row_smem(P, E, kHbm, false, 0)};
}

// Calls f(kernel) with a kernel family's instance for a plan:
// Family::template of<layout, phones in registers, prefetch>(), and
// Family::kWide where its tokens are int32 (S >= 32767 never fits one
// block's shared memory: cudaErrorInvalidValue there).
template <typename Family, typename F>
int with_kernel(const Plan& pl, F&& f) {
  if (pl.layout == kHbm) return f(Family::template of<kHbm, 0, false>());
  if (pl.layout == kCluster) {
    if (pl.ph == 1) return f(Family::template of<kCluster, 1, true>());
    return f(Family::template of<kCluster, 2, true>());
  }
  if constexpr (Family::kWide) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (pl.ph == 0) return f(Family::template of<kBlock, 0, false>());
    if (pl.ph == 1) {
      if (pl.pf) return f(Family::template of<kBlock, 1, true>());
      return f(Family::template of<kBlock, 1, false>());
    }
    if (pl.pf) return f(Family::template of<kBlock, 2, true>());
    return f(Family::template of<kBlock, 2, false>());
  }
}

// The kernel's attributes for a plan: its shared memory and, for a
// cluster of more than 8 blocks, the non-portable size.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, const Plan& pl) {
  cudaError_t err = allow_smem(kernel, pl.smem);
  if (err == cudaSuccess && pl.cs > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t cluster_config(const Plan& pl, int rows,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * pl.cs));
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

// Whether `rows` clusters of the plan can be resident on the card at
// once (cudaOccupancyMaxActiveClusters reports that many or more), in
// *ok; true outside the cluster layout.  A CUDA error of the kernel's
// attributes or of the query is returned, not taken for a size that
// cannot run.
template <typename Family>
cudaError_t launchable(const Plan& pl, int rows, bool* ok) {
  *ok = true;
  if (pl.layout != kCluster) return cudaSuccess;
  int active = 0;
  const int err = with_kernel<Family>(pl, [&](auto kernel) {
    cudaError_t e = prepare(kernel, pl);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(pl, 1, &attr, 0);
    return (int)cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  });
  *ok = err == cudaSuccess && active >= rows;
  if (err != cudaSuccess) cudaGetLastError();  // reported here, not later
  return (cudaError_t)err;
}

// The plan for P phones of E states: `cluster` blocks a row as asked (1:
// one block, the state in shared or, where it does not fit, in global
// memory), or, cluster 0, one block where it holds each thread's phones
// in registers with the prefetch; else the cluster of 2-16 blocks whose
// ranks take at most rank_phones phones (the smallest such, or 16), or
// the next smaller one that holds the row, of which `rows` clusters can
// be resident at once; else the smallest of 2-16 that holds the row and
// of which one can be resident; past those, one block with the state in
// global memory.  K6 asks for the smallest cluster that holds the row
// (rank_phones 2,048: two phones a thread of 1,024) and one resident.
// *ok false where the asked cluster does not fit or cannot run; a CUDA
// error of launchable() is returned.
template <typename Family>
cudaError_t plan_for(int P, int E, int cluster, Plan* pl, bool* ok,
                     int rank_phones = 2048, int rows = 1) {
  *ok = true;
  if (cluster == 1) {
    *pl = one_block(P, E);
    return cudaSuccess;
  }
  if (cluster > 1) {
    *ok = cluster <= kMaxCluster && fits(P, E, cluster, pl);
    return *ok ? launchable<Family>(*pl, 1, ok) : cudaSuccess;
  }
  if (fits(P, E, 1, pl)) return cudaSuccess;
  int want = 2;
  while (want < kMaxCluster && (P + want - 1) / want > rank_phones)
    want *= 2;
  for (int cs = want; cs > 1; cs /= 2) {
    if (!fits(P, E, cs, pl)) continue;
    const cudaError_t err = launchable<Family>(*pl, rows, ok);
    if (err != cudaSuccess || *ok) return err;
  }
  for (int cs = 2; cs <= kMaxCluster; cs *= 2) {
    if (!fits(P, E, cs, pl)) continue;
    const cudaError_t err = launchable<Family>(*pl, 1, ok);
    if (err != cudaSuccess || *ok) return err;
  }
  *ok = true;
  *pl = one_block(P, E);
  return cudaSuccess;
}

// The launch of `rows` rows on a plan's kernel: a cluster launch of
// rows * cs blocks, or rows blocks.
template <typename Kernel, typename Args>
int launch(Kernel kernel, const Plan& pl, int rows, cudaStream_t stream,
           const Args& args) {
  const cudaError_t err = prepare(kernel, pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.layout == kCluster) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(pl, rows, &attr, stream);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
    if (e != cudaSuccess) return (int)e;
  } else {
    kernel<<<rows, pl.threads, pl.smem, stream>>>(args);
  }
  return (int)cudaGetLastError();
}

}  // namespace sst
