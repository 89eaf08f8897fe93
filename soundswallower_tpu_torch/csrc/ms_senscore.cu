// K11 `ms_dist_topn` and K12 `ms_senone_eval`: the fully continuous
// (ms) senone scorer.
//
// K11 replaces B8's soundswallower_tpu/ops/senscore_jax.py
// _dist_stage_ms and the top-N half of _ms_stage (ms_gauden.c
// compute_dist): the float32 Mahalanobis fold, K2's to the bit (one
// fused multiply-add of the rounded square per dim, as XLA's CPU backend
// contracts the JAX fold: vfnmadd per dim in its compiled program), kept
// in float, then the top N by float.  The C insertion puts an equal
// newcomer above the incumbent, so ties go to the LATER density; the
// JAX program ranks the order-preserving integer view of the float
// packed with the density index, which is the order here too (so -0.0
// ranks below +0.0, as there).  A distance below WORST_DIST (INT_MIN as
// a float) ranks below every other and comes out as (WORST_DIST, 0).
// With n_best == D (topn >= D) every density is written in index order,
// unsorted (compute_dist_all).  The TPU program wrote the [N, C, F, D]
// float tensor to HBM (2.6 GB per 128-row chunk at en-us width); here
// only the N winners of each (frame, codebook, stream) leave the SM.
// Bound: operations, 4*L float ops per density and frame (the fold).
// The fold issues 3 FP32 instructions a density, dim and frame
// (__fsub_rn, __fmul_rn, __fmaf_rn with -fmad=false: contracting them
// would change the bits), so at the card's 33.5 T FP32 lane-instructions
// a second the issue floor is 1.5x the bound: the roofline share stops
// near 67%.
// Two forms, chosen by the launcher from the shapes (k11_layout).
// Density form (registers 13, runtime L): K2's design (senscore.cu).
// A block takes a tile of NT frames (16-64,
// K2's sst_dist_topn_tile) of one stream and loops over the C codebooks
// (or over one part of them: k11_layout below);
// each codebook's slice of the model (means, var [D, L], det [D]) is
// copied into shared memory once a tile with cp.async, the next slice's
// copy in flight while this one computes.  A thread owns a density: it
// holds the density's L means and vars in registers across the tile's
// frames at L = 13 (three streams of 13 dims), else reads them from the
// shared slice (the runtime-L form: at the one 39-dim stream of a
// continuous model it ran 2.5-2.8% faster than a form with the 78
// values in registers), and folds four frames at a time; the float distances
// go to a shared [NT][DG] table, from which each warp takes the top N of
// two frames at a time (each lane sorts its four densities once, then a
// pick is two warp reductions: the highest order key among the lanes'
// heads, then the highest index holding it, i.e. the later density;
// where the densities fit a warp, D <= 32, a lane holds one and nothing
// is sorted).
// A model of one codebook a senone (5,126 codebooks) loops long over its
// codebooks while a bounded frame block gives few tiles: there the grid
// also splits the codebooks into parts of at least kPartCodebooks, so
// that the card holds many short blocks, the tile staying at 64 frames
// (each codebook's slice is still staged once a tile).
// Frame form (L = 39, the one stream of a continuous model; top-N up to
// kFrameTopN, or every density): a thread owns kFrameRows adjacent
// frames of a tile of kFrameTile and holds their 39 features in
// registers (a warp past the frames only stages).  For
// each codebook of its part it folds the densities in index order, the
// density's means and vars read from shared memory four dims at a time
// (the whole warp reads one address: a broadcast), and inserts each
// distance into its frame's running top N in registers.  Insertion in
// density order with an equal newcomer placed above the incumbent is C's
// compute_dist insertion: ties go to the later density, by the same
// order key; the floor's key (1) sits below every other.  No distance
// goes to shared memory and nothing is picked across a warp: a codebook
// costs one barrier, behind which the next codebook's slice is restaged
// into rows of 40 floats (cp.async) while this one computes.  A frame's
// N winners of a codebook leave as a float4 and an int4 where N is 4
// (the next codebook's fill the rest of the 32-byte sectors).  The
// codebooks split into parts so that the grid holds kFrameWaves waves
// of resident blocks.
//
// K12 replaces the rest of _ms_stage (ms_senone.c senone_eval,
// ms_mgau.c's best subtraction).  Per senone and stream: fden = the
// rounded-up SENSCR_SHIFT shift of the truncation of each top distance
// (INT_MIN >> shift at the floor), minus the senone's quantized weight of
// that density; the full logmath_add over the N terms on the 8-bit table
// (read as d < len ? table[d] : 0) with both zero guards; the negated sum
// over streams; the acoustic weight's truncation toward zero; the int16
// clamp; then the frame's best subtracted, clamped again.  Out int16
// [N, S] in senone order.
// Bound: operations, 8 int32 operations per (frame, senone, stream, top-N
// entry), and the int16 output.
// Design: the senones in codebook order (ops/senscore_torch.py
// ms_groups, built once per scorer) cut into groups of G (a power of two
// up to 128) that span at most 8 codebooks.  A block takes one group and
// a tile of NT frames: it stages the group's weight rows (uint8, rows an
// odd number of words apart, so that a warp's 32 senones read 32 banks)
// and, for each frame and each of the group's codebooks, the N terms of
// every stream as (fden << 8 | density), so each term is two shared
// reads.  Everything is int32 where the values prove it exact: weights
// and table entries in [0, 255] (checked when the groups are built),
// |fden| <= 2^21 for any distance below 2^31 - 1024, so a stream's score
// stays within 2^22 and the sum over streams within int32.  A block
// whose tile holds a distance at or above 2^31 - 1024 (never a real
// model's: a distance is at most det, whose terms are bounded by the
// float32 variance floor) evaluates its tile in int64 from the global
// tensors instead, the arithmetic of the JAX program.  Each block folds
// its scores' per-frame minimum into a per-frame buffer (atomicMin); the
// second pass subtracts and clamps.  The launcher sets the buffer and
// makes both launches: one K12 call.
#include <algorithm>
#include <climits>

#include "sst_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = SST_MAX_DENSITIES / 32;  // K11: densities a lane ranks
constexpr int kFold = 4;     // K11: frames a thread folds at once
constexpr int kPartCodebooks = 64;  // K11: codebooks a part holds at least
constexpr int kPartWaves = 16;      // K11: blocks an SM, split past this
constexpr int kFrameForm = 1;       // K11: the frame form's code
constexpr int kFrameL = 39;         // K11 frame form: the dims compiled in
constexpr int kFrameLP = 40;        //   a density's row in shared memory
constexpr int kFrameThreads = 256;  //   threads a block
constexpr int kFrameRows = 2;       //   frames a thread
constexpr int kFrameTile = kFrameThreads * kFrameRows;  // frames a block
constexpr int kFrameTopN = 8;       //   top N held in registers at most
constexpr int kFrameWaves = 8;      //   waves of resident blocks a grid
constexpr int kFrameMinCodebooks = 8;  // codebooks a part at least
constexpr float kWorstDist = -2147483648.0f;
constexpr int kGroupMax = 128;            // K12: senones a group holds at most
constexpr int kTermBytes = 64 * 1024;     // K12: a tile's staged terms at most
constexpr int kTileMax = 128;             // K12: frames a tile at most
// K12: a distance below this truncates to an int32 that leaves fden's
// rounding addition in range (2^31 - 1024, exact in float)
constexpr float kNarrowDist = 2147482624.0f;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// n 4-byte words into shared memory (dst 16-byte aligned) with cp.async
// by the whole block: 16 bytes a copy where src is 16-byte aligned, else
// 4 (senscore.cu's stage).
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "4-byte words");
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// -- K11 ----------------------------------------------------------------------

// Floats of one model slice in shared memory: means and var [D, L],
// then det [D], each rounded up to 4.
__host__ __device__ inline int k11_slice_floats(int D, int L) {
  return 2 * round4(D * L) + round4(D);
}

// K11's dynamic shared memory: the tile's features [L][NT], two model
// slices, the distances [NT][DG] (DG = D rounded up to a warp).
inline size_t k11_smem_bytes(int D, int L, int NT) {
  const int DG = (D + 31) & ~31;
  return sizeof(float) * ((size_t)L * NT + 2 * (size_t)k11_slice_floats(D, L) +
                          (size_t)NT * DG);
}

// The order of a distance among those of its frame, codebook and stream
// (the JAX program's packed key without the index): its float's bits as
// an unsigned order, every value at or above WORST_DIST above 1 (its
// lowest, -2^31, is 0x30FFFFFF); 1 below WORST_DIST.
__device__ __forceinline__ unsigned order_key(float d) {
  if (d < kWorstDist) return 1u;
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// K11's density form: kL the dims compiled in (13) or 0 (runtime L),
// kPer the densities a lane ranks
template <int kL, int kPer>
__device__ __forceinline__ void k11_densities(
    const float* __restrict__ feats, const float* __restrict__ means,
    const float* __restrict__ var_t, const float* __restrict__ det,
    float* __restrict__ dval_out, int32_t* __restrict__ cw_out, int N, int C,
    int F, int D, int L_rt, int ne, int NT) {
  extern __shared__ __align__(16) float smk[];
  constexpr bool kReg = kL > 0;
  const int L = kReg ? kL : L_rt;
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  // this block's part of the codebooks
  const int cpp = (C + (int)gridDim.z - 1) / (int)gridDim.z;
  const int c0 = (int)blockIdx.z * cpp;
  const int c1 = min(C, c0 + cpp);
  if (c0 >= c1) return;  // the whole block: no barrier reached
  const int nq = min(NT, N - n0);  // frames of this tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int DG = (D + 31) & ~31;
  const int G = blockDim.x / DG;  // groups of DG threads, frames split
  const int dl = round4(D * L);
  const int slice = k11_slice_floats(D, L);
  float* const xs = smk;                // [L][NT]
  float* const prm = xs + L * NT;       // [2][slice]
  float* const dist = prm + 2 * slice;  // [NT][DG]

  auto stage_slice = [&](int c, float* dst) {
    const size_t cf = (size_t)c * F + f;
    stage(dst, means + cf * D * L, D * L);
    stage(dst + dl, var_t + cf * D * L, D * L);
    stage(dst + 2 * dl, det + cf * D, D);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage_slice(c0, prm);
  // the tile's features of stream f, transposed; frames past N read 0
  for (int i = tid; i < L * NT; i += blockDim.x) {
    const int l = i / NT, q = i - l * NT;
    const int n = n0 + q;
    xs[i] = n < N ? feats[((size_t)n * F + f) * L + l] : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int d = tid % DG;
  const int grp = tid / DG;
  for (int c = c0; c < c1; ++c) {
    const float* const pm = prm + ((c - c0) & 1) * slice;
    if (c + 1 < c1) stage_slice(c + 1, prm + ((c + 1 - c0) & 1) * slice);
    // -- the distances of this thread's density, kFold frames at a time --
    if (d < D && grp < G) {
      const float* const mu_s = pm + d * L;
      const float* const vr_s = pm + dl + d * L;
      float mu_r[kReg ? kL : 1], vr_r[kReg ? kL : 1];
      if constexpr (kReg) {
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          mu_r[l] = mu_s[l];
          vr_r[l] = vr_s[l];
        }
      }
      const float dt = pm[2 * dl + d];
      for (int q0 = kFold * grp; q0 < NT; q0 += kFold * G) {
        float acc[kFold];
#pragma unroll
        for (int i = 0; i < kFold; ++i) acc[i] = dt;
        auto dim = [&](int l, float mu, float vr) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + l * NT + q0);
          const float x[kFold] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < kFold; ++i) {
            const float diff = __fsub_rn(x[i], mu);
            // acc - (diff * diff) * var, the product unrounded: the FMA
            // XLA's CPU backend makes of the JAX fold
            acc[i] = __fmaf_rn(-__fmul_rn(diff, diff), vr, acc[i]);
          }
        };
        if constexpr (kReg) {
#pragma unroll
          for (int l = 0; l < kL; ++l) dim(l, mu_r[l], vr_r[l]);
        } else {
          for (int l = 0; l < L; ++l) dim(l, mu_s[l], vr_s[l]);
        }
#pragma unroll
        for (int i = 0; i < kFold; ++i) dist[(q0 + i) * DG + d] = acc[i];
      }
    }
    __syncthreads();
    if (ne >= D) {
      // compute_dist_all: every density in index order, unsorted, no floor
      for (int i = tid; i < nq * D; i += blockDim.x) {
        const int q = i / D, dd = i - q * D;
        const size_t o = (((size_t)(n0 + q) * C + c) * F + f) * ne + dd;
        dval_out[o] = dist[q * DG + dd];
        cw_out[o] = dd;
      }
    } else {
      // the top N of each frame, two frames a warp at a time (q and
      // q + nwarps), so that the two picks' reduction chains overlap
      for (int q0 = warp; q0 < nq; q0 += 2 * nwarps) {
        const int q1 = q0 + nwarps;
        const bool two = q1 < nq;  // warp-uniform
        // each frame: this lane's densities lane + 32 k, sorted once by
        // order key, then index, both highest first; absent densities
        // (key 0) last, never picked while a density is left
        unsigned key[2][kPer];
        int ix[2][kPer];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = u && two ? q1 : q0;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int dd = lane + 32 * k;
            key[u][k] = dd < D ? order_key(dist[q * DG + dd]) : 0u;
            ix[u][k] = dd < D ? dd : -1;
          }
        }
        auto cswap = [&](int u, int i, int j) {  // (i, j) in order after
          const bool sw = key[u][j] > key[u][i] ||
                          (key[u][j] == key[u][i] && ix[u][j] > ix[u][i]);
          const unsigned ki = key[u][i];
          const int ii = ix[u][i];
          key[u][i] = sw ? key[u][j] : ki;
          ix[u][i] = sw ? ix[u][j] : ii;
          key[u][j] = sw ? ki : key[u][j];
          ix[u][j] = sw ? ii : ix[u][j];
        };
        static_assert(kPer == 1 || kPer == 4, "the sorting network sorts 4");
        if constexpr (kPer == 4) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            cswap(u, 0, 1);
            cswap(u, 2, 3);
            cswap(u, 0, 2);
            cswap(u, 1, 3);
            cswap(u, 1, 2);
          }
        }
        // pick j is held by lane j % 32: its density, -1 at the floor;
        // every 32 picks (and after the last) the lanes write theirs
        int mine[2] = {0, 0};
        for (int j = 0; j < ne; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const unsigned m = __reduce_max_sync(0xffffffffu, key[u][0]);
            const int idx = __reduce_max_sync(
                0xffffffffu, key[u][0] == m ? ix[u][0] : -1);
            if (ix[u][0] == idx) {  // this lane's head was taken: shift
#pragma unroll
              for (int k = 0; k + 1 < kPer; ++k) {
                key[u][k] = key[u][k + 1];
                ix[u][k] = ix[u][k + 1];
              }
              key[u][kPer - 1] = 0u;
              ix[u][kPer - 1] = -1;
            }
            if (lane == (j & 31)) mine[u] = m == 1u ? -1 : idx;
          }
          if ((j & 31) == 31 || j == ne - 1) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u == 1 && !two) break;
              const int q = u ? q1 : q0;
              if (lane <= (j & 31)) {
                const size_t o = (((size_t)(n0 + q) * C + c) * F + f) * ne +
                                 (j & ~31) + lane;
                const int dd = mine[u];
                dval_out[o] = dd < 0 ? kWorstDist : dist[q * DG + dd];
                cw_out[o] = dd < 0 ? 0 : dd;
              }
            }
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
}

// Floats of one model slice of the frame form in shared memory: means
// and var [D, kFrameLP], then det [D] rounded up to 4.
__host__ __device__ inline int k11f_slice_floats(int D) {
  return 2 * D * kFrameLP + round4(D);
}

// The frame form's dynamic shared memory: two slices.
inline size_t k11f_smem_bytes(int D) {
  return sizeof(float) * 2 * (size_t)k11f_slice_floats(D);
}

// The float whose order_key is k (k > 1).
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Insert (v, d) into a top N sorted by key, then index, highest first;
// d is above every index held, so it goes above each key it equals.
template <int kN>
__device__ __forceinline__ void topn_insert(unsigned (&key)[kN],
                                            int (&ix)[kN], unsigned v,
                                            int d) {
  bool above[kN];  // v at or above slot j: true from some j down
#pragma unroll
  for (int j = 0; j < kN; ++j) above[j] = v >= key[j];
#pragma unroll
  for (int j = kN - 1; j > 0; --j) {
    key[j] = above[j - 1] ? key[j - 1] : (above[j] ? v : key[j]);
    ix[j] = above[j - 1] ? ix[j - 1] : (above[j] ? d : ix[j]);
  }
  key[0] = above[0] ? v : key[0];
  ix[0] = above[0] ? d : ix[0];
}

// K11's frame form: kN slots of the top N a frame (ne <= kN), or 0:
// every density written in index order (ne == D).
template <int kN>
__device__ __forceinline__ void k11_frames(
    const float* __restrict__ feats, const float* __restrict__ means,
    const float* __restrict__ var_t, const float* __restrict__ det,
    float* __restrict__ dval_out, int32_t* __restrict__ cw_out, int N, int C,
    int F, int D, int ne) {
  extern __shared__ __align__(16) float smk[];
  constexpr int R = kFrameRows;
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * kFrameTile;
  const int cpp = (C + (int)gridDim.z - 1) / (int)gridDim.z;
  const int c0 = (int)blockIdx.z * cpp;
  const int c1 = min(C, c0 + cpp);
  if (c0 >= c1) return;  // the whole block: no barrier reached
  const int tid = threadIdx.x;
  const int slice = k11f_slice_floats(D);
  const int dl = D * kFrameLP;

  // codebook c's slice into dst: row d of means and var at d * kFrameLP
  auto stage_slice = [&](int c, float* dst) {
    const size_t cf = (size_t)c * F + f;
    const float* const mu = means + cf * D * kFrameL;
    const float* const vr = var_t + cf * D * kFrameL;
    for (int i = tid; i < D * kFrameL; i += kFrameThreads) {
      const int o = i + i / kFrameL;  // d * kFrameLP + (i - d * kFrameL)
      cp_async4(dst + o, mu + i);
      cp_async4(dst + dl + o, vr + i);
    }
    for (int i = tid; i < D; i += kFrameThreads)
      cp_async4(dst + 2 * dl + i, det + cf * D + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_slice(c0, smk);

  // this thread's frames n0 + R * tid + r; past N, the last frame's
  // features (computed, never written)
  int n[R];
  float x[R][kFrameL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    n[r] = n0 + R * tid + r;
    const float* const src =
        feats + ((size_t)min(n[r], N - 1) * F + f) * kFrameL;
#pragma unroll
    for (int l = 0; l < kFrameL; ++l) x[r][l] = src[l];
  }
  // a warp with no frame below N only stages
  const bool busy = n0 + R * (tid & ~31) < N;

  for (int c = c0; c < c1; ++c) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // slice c landed; slice c - 1's buffer is free
    const float* const pm = smk + ((c - c0) & 1) * slice;
    if (c + 1 < c1) stage_slice(c + 1, smk + ((c + 1 - c0) & 1) * slice);
    if (!busy) continue;
    size_t o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = (((size_t)n[r] * C + c) * F + f) * ne;
    unsigned key[R][kN > 0 ? kN : 1];
    int ix[R][kN > 0 ? kN : 1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < (kN > 0 ? kN : 1); ++j) {
        key[r][j] = 0u;  // below every density's key
        ix[r][j] = 0;
      }
    for (int d = 0; d < D; ++d) {
      const float* const mu = pm + d * kFrameLP;
      const float* const vr = pm + dl + d * kFrameLP;
      float acc[R];
      const float dt = pm[2 * dl + d];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = dt;
#pragma unroll
      for (int l4 = 0; l4 < kFrameLP; l4 += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(mu + l4);
        const float4 v4 = *reinterpret_cast<const float4*>(vr + l4);
        const float m[4] = {m4.x, m4.y, m4.z, m4.w};
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (l4 + k < kFrameL) {  // the row's padding word unread
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float diff = __fsub_rn(x[r][l4 + k], m[k]);
              acc[r] = __fmaf_rn(-__fmul_rn(diff, diff), v[k], acc[r]);
            }
          }
        }
      }
      if constexpr (kN == 0) {
        // compute_dist_all: every density in index order, unsorted
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (n[r] < N) {
            dval_out[o[r] + d] = acc[r];
            cw_out[o[r] + d] = d;
          }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          topn_insert<kN>(key[r], ix[r], order_key(acc[r]), d);
      }
    }
    if constexpr (kN > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (n[r] >= N) continue;
        float dv[kN];
        int cv[kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const bool floor = key[r][j] == 1u;
          dv[j] = floor ? kWorstDist : key_float(key[r][j]);
          cv[j] = floor ? 0 : ix[r][j];
        }
        if constexpr (kN % 4 == 0) {
          if (ne == kN) {  // 16-byte aligned: o is a multiple of 4
#pragma unroll
            for (int j = 0; j < kN; j += 4) {
              *reinterpret_cast<float4*>(dval_out + o[r] + j) =
                  make_float4(dv[j], dv[j + 1], dv[j + 2], dv[j + 3]);
              *reinterpret_cast<int4*>(cw_out + o[r] + j) =
                  make_int4(cv[j], cv[j + 1], cv[j + 2], cv[j + 3]);
            }
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < kN; ++j)
          if (j < ne) {
            dval_out[o[r] + j] = dv[j];
            cw_out[o[r] + j] = cv[j];
          }
      }
    }
  }
}

// K11: the frame form (kFrames; kA the top N's slots, 0 for every
// density) or the density form (kA its compiled dims or 0, kB the
// densities a lane ranks).  One name for both: the device trace sums K11
// by it.
template <bool kFrames, int kA, int kB>
__global__ void __launch_bounds__(kFrames ? kFrameThreads : kThreads)
    ms_dist_topn_kernel(const float* __restrict__ feats,
                        const float* __restrict__ means,
                        const float* __restrict__ var_t,
                        const float* __restrict__ det,
                        float* __restrict__ dval_out,
                        int32_t* __restrict__ cw_out, int N, int C, int F,
                        int D, int L, int ne, int NT) {
  if constexpr (kFrames)
    k11_frames<kA>(feats, means, var_t, det, dval_out, cw_out, N, C, F, D,
                   ne);
  else
    k11_densities<kA, kB>(feats, means, var_t, det, dval_out, cw_out, N, C,
                          F, D, L, ne, NT);
}

// -- K12 ----------------------------------------------------------------------

// logmath_add with the JAX program's guards (senscore_jax.py:373-383) on
// the 8-bit table (tab[table_len] == 0 stands for every d past its end)
template <typename T>
__device__ __forceinline__ T ms_logadd(T x, T y, const uint8_t* tab,
                                       int table_len, T zero) {
  const T r = x > y ? x : y;
  const T d = r - (x > y ? y : x);
  T res = r + (T)tab[d < (T)table_len ? (int)d : table_len];
  if (x <= zero) res = y;
  if (y <= zero) res = x <= zero ? res : x;
  return res;
}

// The negated stream sum, truncated by the acoustic weight, clamped to int16
template <typename T>
__device__ __forceinline__ int ms_score(T sum, int aw) {
  T scr = -sum;
  if (aw != 1) scr = scr < 0 ? -((-scr) / aw) : scr / aw;
  return (int)(scr < -32768 ? -32768 : (scr > 32767 ? 32767 : scr));
}

// K12's dynamic shared memory: the group's weight rows [G][row], the
// tile's terms [NT][U][F * ne] (int32), its per-frame minima [NT], the
// table [table_len + 1] (uint8)
inline size_t k12_smem_bytes(int G, int row, int U, int Fn, int NT,
                             int table_len) {
  return (size_t)G * row + sizeof(int32_t) * ((size_t)NT * U * Fn + NT) +
         round4(table_len + 1);
}

// K12's frame tile: the most frames (128 down to 1, powers of two) whose
// terms fit kTermBytes, halved (down to 16) while the grid of
// ceil(N / tile) x groups blocks would give the sms SMs fewer than two
// blocks each; 0 where one frame's terms do not fit.
int k12_tile(int N, int n_groups, int U, int Fn, int sms) {
  const long per = 4L * U * Fn;
  if (per > kTermBytes) return 0;
  int tile = kTileMax;
  while (tile > 1 && tile * per > kTermBytes) tile /= 2;
  while (tile > 16 && (long)((N + tile - 1) / tile) * n_groups < 2L * sms)
    tile /= 2;
  return tile;
}

__global__ void __launch_bounds__(kThreads) ms_senone_eval_kernel(
    const float* __restrict__ dval, const int32_t* __restrict__ cw,
    const uint8_t* __restrict__ wts, int row, const int32_t* __restrict__ order,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ gcb, int G,
    int U, const int32_t* __restrict__ table, int table_len,
    int16_t* __restrict__ out, int32_t* __restrict__ fmin, int N, int C,
    int F, int D, int S, int ne, int zero8, int aw, int NT) {
  extern __shared__ __align__(16) uint8_t smb[];
  const int Fn = F * ne;
  uint8_t* const w = smb;                                        // [G][row]
  int32_t* const terms = reinterpret_cast<int32_t*>(w + G * row);  // [NT][U][Fn]
  int32_t* const tmin = terms + NT * U * Fn;                     // [NT]
  uint8_t* const tab = reinterpret_cast<uint8_t*>(tmin + NT);   // [table_len + 1]
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  const int nq = min(NT, N - n0);
  const int p0 = g * G;
  const int cnt = min(G, S - p0);
  const int tid = threadIdx.x;

  // the group's weight rows: one contiguous span in codebook order
  stage(reinterpret_cast<uint32_t*>(w),
        reinterpret_cast<const uint32_t*>(wts + (size_t)p0 * row),
        cnt * row / 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < table_len; i += blockDim.x) tab[i] = (uint8_t)table[i];
  if (tid == 0) tab[table_len] = 0;
  for (int q = tid; q < NT; q += blockDim.x) tmin[q] = INT_MAX;
  // the tile's terms of the group's codebooks: (fden << 8) | density
  bool wide = false;
  const int per = U * Fn;
  for (int i = tid; i < nq * per; i += blockDim.x) {
    const int q = i / per, r = i - q * per;
    const int u = r / Fn, k = r - u * Fn;
    const int cb = gcb[g * U + u];
    if (cb < 0) continue;  // past this group's codebooks
    const size_t src = ((size_t)(n0 + q) * C + cb) * Fn + k;
    const float dv = dval[src];
    wide |= !(dv < kNarrowDist);
    const int fden = dv < kWorstDist
                         ? (INT_MIN >> SST_SENSCR_SHIFT)
                         : ((int)dv + ((1 << SST_SENSCR_SHIFT) - 1)) >>
                               SST_SENSCR_SHIFT;
    terms[i] = fden * 256 + (cw[src] & 0xFF);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  wide = __syncthreads_or(wide);

  // a thread a senone of the group and every H-th frame of the tile
  const int pl = tid % G;
  const int H = blockDim.x / G;
  const bool live = pl < cnt;
  const int p = p0 + (live ? pl : 0);
  const int u = slot[p];
  const int cb = gcb[g * U + u];
  const uint8_t* const wr = w + pl * row;
  int16_t* const o = out + order[p];
  for (int q = tid / G; q < nq; q += H) {
    const int n = n0 + q;
    int scr = INT_MAX;
    if (live && !wide) {
      const int32_t* const t = terms + (q * U + u) * Fn;
      int sum = 0;
      for (int f = 0; f < F; ++f) {
        const uint8_t* const wf = wr + f * D;
        int fs = 0;
        for (int j = 0; j < ne; ++j) {
          const int tv = t[f * ne + j];
          const int y = (tv >> 8) - (int)wf[tv & 0xFF];
          fs = j == 0 ? y : ms_logadd<int>(fs, y, tab, table_len, zero8);
        }
        sum += fs;
      }
      scr = ms_score<int>(sum, aw);
    } else if (live) {
      // a distance past the int32 range in this tile: the JAX program's
      // int64 arithmetic, the terms read from the global tensors
      const long long floor_den = (long long)INT_MIN >> SST_SENSCR_SHIFT;
      long long sum = 0;
      for (int f = 0; f < F; ++f) {
        const size_t q0 = (((size_t)n * C + cb) * F + f) * ne;
        const uint8_t* const wf = wr + f * D;
        long long fs = 0;
        for (int j = 0; j < ne; ++j) {
          const float dv = dval[q0 + j];
          const long long fden =
              dv < kWorstDist ? floor_den
                              : ((long long)dv + ((1 << SST_SENSCR_SHIFT) - 1)) >>
                                    SST_SENSCR_SHIFT;
          const long long y = fden - (long long)wf[cw[q0 + j]];
          fs = j == 0 ? y
                      : ms_logadd<long long>(fs, y, tab, table_len, zero8);
        }
        sum += fs;
      }
      scr = ms_score<long long>(sum, aw);
    }
    if (live) o[(size_t)n * S] = (int16_t)scr;
    // the frame's minimum: a warp's lanes share the frame where G >= 32
    if (G >= 32) {
      scr = __reduce_min_sync(0xffffffffu, scr);
      if ((tid & 31) == 0) atomicMin(tmin + q, scr);
    } else if (live) {
      atomicMin(tmin + q, scr);
    }
  }
  __syncthreads();
  for (int q = tid; q < nq; q += blockDim.x) atomicMin(fmin + n0 + q, tmin[q]);
}

// pass 2: each frame's best subtracted, clamped (a block a row at a time)
__global__ void __launch_bounds__(kThreads) ms_best_sub_kernel(
    int16_t* __restrict__ out, const int32_t* __restrict__ fmin, int N,
    int S) {
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int m = fmin[n];
    int16_t* const o = out + (size_t)n * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int v = (int)o[s] - m;
      o[s] = (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
    }
  }
}

// Whether K11's frame form takes a shape: L = kFrameL, and a top N that
// its registers hold or every density (D <= SST_MAX_DENSITIES and
// 1 <= ne <= D checked by the launcher).
bool k11_frames_take(int D, int L, int ne) {
  return L == kFrameL && (ne <= kFrameTopN || ne == D);
}

using K11Kernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, int32_t*, int, int, int,
                           int, int, int, int);
// The frame form's kernel for a top N of ne of D densities: 4 slots up
// to a top 4, kFrameTopN past it, none for every density.
K11Kernel k11_frame_kernel(int D, int ne) {
  if (ne == D) return ms_dist_topn_kernel<true, 0, 0>;
  if (ne <= 4) return ms_dist_topn_kernel<true, 4, 0>;
  return ms_dist_topn_kernel<true, kFrameTopN, 0>;
}

// K11's launch for N frames of F streams over C codebooks of D densities
// and L dims, top ne: the frame tile, the parts the codebooks are split
// into, and the form (kFrameForm; 13: the density form with L compiled
// in, the model rows in registers; 0: its runtime-L form).  The frame
// form wherever it takes the shape; its tile is kFrameTile, and where
// the tiles give fewer than kFrameWaves waves of the blocks the card
// holds at once, the codebooks split into as many parts as reach that,
// of at least kFrameMinCodebooks.  The density form with one part: K2's
// tile (sst_dist_topn_tile); where the tiles of 64 frames give fewer
// than kPartWaves blocks an SM and the codebooks make at least two parts
// of kPartCodebooks, the tile stays 64 and the codebooks split into as
// many parts as reach kPartWaves blocks an SM.  ``form`` >= 0 forces a
// form (13 only at L = 13, kFrameForm where it takes the shape),
// ``split`` > 0 the parts (then the density form's tile is 64 where
// they are more than one).
int k11_layout(int N, int C, int F, int D, int L, int ne, int form,
               int split, int* tile, int* parts, int* kl) {
  int sms = 0;
  if (sst_device_attr(cudaDevAttrMultiProcessorCount, &sms) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  const bool frames = k11_frames_take(D, L, ne);
  if (form < 0) form = frames ? kFrameForm : (L == 13 ? 13 : 0);
  if (form == kFrameForm ? !frames
                         : form != 0 && !(form == 13 && L == 13))
    return (int)cudaErrorInvalidValue;
  *kl = form;
  *parts = 1;
  if (form == kFrameForm) {
    *tile = kFrameTile;
    const K11Kernel kernel = k11_frame_kernel(D, ne);
    const size_t smem = k11f_smem_bytes(D);
    int per_sm = 0;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kFrameThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const long base =
        std::max(1L, (long)((N + kFrameTile - 1) / kFrameTile) * F);
    const long want = (long)kFrameWaves * std::max(per_sm, 1) * sms;
    if (split > 0) {
      *parts = std::min(split, C);
    } else if (base < want) {
      *parts = (int)std::min<long>(
          std::max(1, C / kFrameMinCodebooks), (want + base - 1) / base);
    }
    return (int)cudaSuccess;
  }
  const long base = std::max(1L, (long)((N + 63) / 64) * F);
  const long want = (long)kPartWaves * sms;
  if (split > 0) {
    *parts = std::min(split, C);
  } else if (base < want && C >= 2 * kPartCodebooks) {
    *parts = (int)std::min<long>(C / kPartCodebooks, (want + base - 1) / base);
  }
  if (*parts > 1) {
    *tile = 64;
  } else {
    *tile = sst_dist_topn_tile(N, F);
    if (*tile < 0) return (int)cudaErrorInvalidDevice;
  }
  return (int)cudaSuccess;
}

int ms_dist_topn(const float* feats, const float* means, const float* var_t,
                 const float* det, float* dval, int32_t* cw, int N, int C,
                 int F, int D, int L, int ne, int form, int split,
                 cudaStream_t stream) {
  if (D > SST_MAX_DENSITIES || D < 1 || L < 1 || F < 1 || ne < 1 || ne > D)
    return (int)cudaErrorInvalidValue;
  if (N <= 0 || C <= 0) return (int)cudaSuccess;
  int tile = 0, parts = 1, kl = 0;
  const int lerr =
      k11_layout(N, C, F, D, L, ne, form, split, &tile, &parts, &kl);
  if (lerr != (int)cudaSuccess) return lerr;
  const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)F,
                  (unsigned)parts);
  auto go = [&](K11Kernel kernel, int threads, size_t smem) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, threads, smem, stream>>>(feats, means, var_t, det, dval, cw,
                                            N, C, F, D, L, ne, tile);
    return (int)cudaGetLastError();
  };
  if (kl == kFrameForm)
    return go(k11_frame_kernel(D, ne), kFrameThreads, k11f_smem_bytes(D));
  const size_t smem = k11_smem_bytes(D, L, tile);
  const int DG = (D + 31) & ~31;
  const int threads = kThreads / DG * DG;
  // a lane ranks one density where D fits a warp, else four
  if (D <= 32)
    return kl == 13 ? go(ms_dist_topn_kernel<false, 13, 1>, threads, smem)
                    : go(ms_dist_topn_kernel<false, 0, 1>, threads, smem);
  return kl == 13
             ? go(ms_dist_topn_kernel<false, 13, kPerLane>, threads, smem)
             : go(ms_dist_topn_kernel<false, 0, kPerLane>, threads, smem);
}

}  // namespace

extern "C" int sst_ms_dist_topn(const float* feats, const float* means,
                                const float* var_t, const float* det,
                                float* dval, int32_t* cw, int N, int C, int F,
                                int D, int L, int ne, cudaStream_t stream) {
  return ms_dist_topn(feats, means, var_t, det, dval, cw, N, C, F, D, L, ne,
                      -1, 0, stream);
}

extern "C" int sst_ms_dist_topn_at(const float* feats, const float* means,
                                   const float* var_t, const float* det,
                                   float* dval, int32_t* cw, int N, int C,
                                   int F, int D, int L, int ne, int form,
                                   int parts, cudaStream_t stream) {
  if (form < 0 || parts < 0) return (int)cudaErrorInvalidValue;
  return ms_dist_topn(feats, means, var_t, det, dval, cw, N, C, F, D, L, ne,
                      form, parts, stream);
}

extern "C" int sst_ms_dist_topn_layout(int N, int C, int F, int D, int L,
                                       int ne, int32_t* out) {
  if (D > SST_MAX_DENSITIES || D < 1 || L < 1 || F < 1 || ne < 1 || ne > D)
    return (int)cudaErrorInvalidValue;
  int tile = 0, parts = 1, kl = 0;
  const int err =
      k11_layout(N, C, F, D, L, ne, -1, 0, &tile, &parts, &kl);
  if (err != (int)cudaSuccess) return err;
  out[0] = tile;
  out[1] = parts;
  out[2] = kl;
  return (int)cudaSuccess;
}

extern "C" int sst_ms_senone_eval_tile(int N, int S, int G, int U, int F,
                                       int ne) {
  int sms = 0;
  if (G < 1 || S < 1 ||
      sst_device_attr(cudaDevAttrMultiProcessorCount, &sms) != cudaSuccess)
    return -1;
  return k12_tile(N, (S + G - 1) / G, U, F * ne, sms);
}

extern "C" int sst_ms_senone_eval(const float* dval, const int32_t* cw,
                                  const uint8_t* wts, int row,
                                  const int32_t* order, const int32_t* slot,
                                  const int32_t* gcb, int G, int U,
                                  const int32_t* table, int table_len,
                                  int16_t* out, int32_t* fmin, int N, int C,
                                  int F, int D, int S, int ne, int zero8,
                                  int aw, cudaStream_t stream) {
  // int32 sums need few streams; a term packs its density into 8 bits;
  // a group is a power of two that divides the block
  if (aw < 1 || ne < 1 || F < 1 || F > 64 || D < 1 || D > 256 ||
      table_len < 0 || U < 1 || G < 1 || G > kGroupMax || (G & (G - 1)) ||
      row < F * D || (row & 3))
    return (int)cudaErrorInvalidValue;
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sst_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (S + G - 1) / G;
  const int tile = k12_tile(N, n_groups, U, F * ne, sms);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = k12_smem_bytes(G, row, U, F * ne, tile, table_len);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ms_senone_eval_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // every frame's minimum starts above any int16 score
  err = cudaMemsetAsync(fmin, 0x7f, sizeof(int32_t) * (size_t)N, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)n_groups);
  ms_senone_eval_kernel<<<grid, kThreads, smem, stream>>>(
      dval, cw, wts, row, order, slot, gcb, G, U, table, table_len, out, fmin,
      N, C, F, D, S, ne, zero8, aw, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_best_sub_kernel<<<(unsigned)min(N, 8 * sms), kThreads, 0, stream>>>(
      out, fmin, N, S);
  return (int)cudaGetLastError();
}
