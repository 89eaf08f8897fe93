// The per-phone frame step shared by the Viterbi kernels K4
// (viterbi.cu) and K6 (viterbi_rows.cu): XLA's wrapping int32 adds, the
// two layouts of a block's Viterbi state, and hmm.c's 3- and 5-state
// updates (align_jax.py _eval_3st_lanes, _eval_5st) with the
// renormalization rule.
#pragma once

#include <climits>
#include <type_traits>

#include "sst_kernels.h"

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

// Block-wide max of v, returned to every thread, as block_max, but
// each warp takes the max of the warp maxima with one shared load a
// lane and one reduction (block_max walks all of them in every thread).
// Needs a block of whole warps.
__device__ __forceinline__ int32_t block_max_warps(int32_t v, int32_t* wmax) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) wmax[tid >> 5] = v;
  __syncthreads();
  const int32_t w = lane < (int)(blockDim.x >> 5) ? wmax[lane] : kWorst;
  return __reduce_max_sync(0xffffffffu, w);
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
// are one block's arrays; K6's cluster form (viterbi_rows.cu) maps a
// phone of another block of the cluster into that block's shared memory.
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
template <int KR>
__device__ __forceinline__ void enter_argmax(
    int n, int K, const int32_t* src_r, const int32_t* pen_r,
    const int32_t* __restrict__ pi, const int32_t* __restrict__ pp, int ks,
    const int32_t* osc, const int32_t* ohi, const uint8_t* anext,
    int32_t* es, int32_t* eh, bool* eok) {
  int32_t s = kWorst, h = -1;
  bool o = false;
  auto slot = [&](int k, int src, int32_t pen) {
    const bool ok = anext[src];
    const int32_t val = ok ? wadd(osc[src], pen) : kWorst;
    if (k == 0 || val > s) {
      s = val;
      h = ohi[src];
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

}  // namespace sst
