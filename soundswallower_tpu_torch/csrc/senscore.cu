// K2 `dist_topn_norm` and K3 `senone_eval`: graph-restricted senone
// scoring.
//
// K2 replaces the jitted XLA programs B2 and the top-N/norm half of B3
// of the JAX package: soundswallower_tpu/ops/senscore_jax.py
// _dist_stage_graph (+ _int_dist) and _topn_sen_stage_graph (+
// _topn_argmax); over all codebooks (Cu = n_cb) also B7's _dist_stage
// and _topn_stage and the norm of _sen_eval, the function of the
// removed Pallas kernel P1 (tools/exp_pallas2.py dist_topn_fused2).  The
// TPU program wrote the [N, Cu, F, D] int32 distance tensor to HBM
// between two dispatches; here it never leaves the SM: only the N
// winners and their scores do.
//
// Bound: operations, 4*L float ops per density and frame.  What the
// design does about it: one block takes a tile of NT frames (16-64,
// sst_dist_topn_tile: 64 where that still gives every SM two blocks) of
// one stream f and loops over the Cu codebooks.  Each (codebook, stream)
// slice of the model (means, var and det; mu*var and c for the mxu form)
// is copied into shared memory once per tile with cp.async, the next
// slice's copy in flight while this one computes (double buffer), so the
// model crosses L2 -> SM once per tile of frames, not once per frame.
// Each thread owns one density: it holds the density's L means and vars
// (at L = 13) in registers across the tile's frames and folds four
// frames at a time (four independent chains), reading the tile's
// features (shared, [L][NT]) four frames to a 16-byte load; the int32
// distances go to a shared [NT][D] table, from which each warp takes the
// top N of two frames at a time: each lane sorts its four densities
// once, then a pick is two warp reductions (__reduce_max_sync of the
// lanes' heads, __reduce_min_sync of the lowest index holding it) and a
// shift; the warp keeps each frame's running codebook norm; the raw
// top-N scores go out and are normalized in place after the last
// codebook.  The fold and the picks alternate between two barriers a
// codebook; forms that overlap them (four fold warps beside four pick
// warps, or every warp folding one codebook and picking the last between
// one barrier a codebook) ran no faster in trial builds, as where both
// phases are bound by instruction issue.  No tensor cores: a TF32 or
// wgmma product rounds its inputs and sums in another order.
//
// K2's mxu form (template flag kMxu) replaces the mxu branches of B2 and
// B7 (_dist_stage_graph :538-545, _distances_mxu :179-188): the TPU ran
// the expanded distance as two einsums on its matrix unit.  Here it stays
// fused with the top-N like the fold: per density, xv = sum_l x_l^2 v_l
// and xmv = sum_l x_l (mu v)_l, each a chain of FMAs from 0 in dim order
// (how XLA's CPU dot reduces them), then d = ((det - c) - xv) + 2 xmv
// with the per-table constants mu v and c made on the host
// (senscore_torch.mxu_constants).  No GEMM: a library product would sum
// in another order.  4*L float ops per density and frame, as the fold.
//
// K3 replaces the senone-evaluation half of B3 (_topn_sen_stage_graph
// + _fast_logadd).  The TPU program looked the mixture weights up with
// a one-hot bf16 matmul on the MXU; here the weights are read directly
// from the [F, D, S] uint8 table and the 8-bit log-add reads the table
// in shared memory, which equals the TPU's staircase sum
// (ScorerTables.from_am asserts the staircase rebuilds the table).
// Bound: operations, about 6 int32 operations per (frame, state, stream,
// top-N entry).
// Design (K12's, ms_senscore.cu): a block takes a range of G consecutive
// columns (128, or 64 or 32 where that wastes fewer of the last range's
// lanes, k3_cols) and a tile of NT frames (128, halved to 16 while the
// card would be short of blocks, k3_tile); the ranges of a tile are
// neighbours in the grid, so they run together and read the tile's
// terms from HBM once.  A block stages its columns' weights
// mixw[:, :, range] once, F*D rows of G bytes an odd number of words
// apart (a warp whose columns read different cw reads different banks),
// and the table.  It reads cb_pos for its columns and finds their U
// distinct codebooks itself (first occurrence order), so no host
// structure is built per scorer (the fresh route builds a union scorer
// every batch).  Then it stages the top-N terms of those codebooks,
// each packed in 16 bits as (s << 7) | cw (s lies in [0,
// SST_MAX_NEG_ASCR] after K2's norm and cw < D <= 128), for as many of
// the tile's frames as its term buffer holds (20 KB, k3_term_bytes, so
// that three blocks fit an SM at en-us width): where U codebooks
// outnumber what the buffer holds for the whole tile, the block takes
// the tile's frames in passes, every column in every pass.  Both
// stagings keep eight loads a thread in flight before the first store
// (the weights a warp-wide row at a time, rows of any alignment
// funnel-shifted into words): issued one by one they leave each block
// waiting on L2 latency.  A thread takes one column and every
// (256 / G)-th frame of a pass, two frames' chains at once: per stream
// the log-add over j in order, the first term as it is, wrap_u8's
// & 0xFF, then the int32 sum over streams.  The table sits in shared
// memory zero-padded to 768 entries, and a difference reads it at
// min(diff, 767), whose entry is 0: the running log-add goes below 0,
// so a difference can pass the table's end, and there the guard's 0 is
// what it reads.  A pass whose terms hold an s outside [0, 511] (no K2
// output does), or a table of 768 entries or more, reads the terms from
// global memory and the table with the guard instead.  top-N and
// wrap_u8 are template parameters.
//
// Both are bit-equal to the JAX programs: the fold is rounded as XLA's
// CPU backend rounds it (each step one fused multiply-add of the rounded
// square, written out with intrinsics; built with -fmad=false so that
// nothing else contracts), float->int truncates with an explicit
// INT_MIN clamp, and every tie goes to the lowest index.  K3 at the
// full inventory (S = n_sen, cb_pos = sen2cb) is B7's mixture eval.
#include <climits>
#include <type_traits>

#include "sst_kernels.h"

namespace {

constexpr int kPerLane = SST_MAX_DENSITIES / 32;
constexpr int kK2Threads = 256;      // K2 block
constexpr int kK2Fold = 4;           // frames a K2 thread folds at once
constexpr int kK2L = 13;             // the dims whose model rows sit in registers
constexpr int kK3Threads = 256;          // K3 block
constexpr int kK3TermBytes = 20 * 1024;  // K3: a pass's staged terms at most
constexpr int kK3TileMax = 128;          // K3: frames a tile at most
constexpr int kK3Ilp = 2;                // K3: frames a thread scores at once
constexpr int kK3Rows = 8;               // K3: staging loads a thread has in flight
constexpr int kK3Tab = 768;              // K3: the table's entries in shared memory

__device__ __forceinline__ int32_t int_dist(float d) {
  // XLA's convert truncates toward zero; _int_dist clamps below INT_MIN.
  // (cvt.rzi would saturate there too, but the clamp is the contract.)
  return d < -2147483648.0f ? INT_MIN : (int32_t)d;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// n floats into shared memory (dst 16-byte aligned) with cp.async by the
// whole block: 16 bytes a copy where src is 16-byte aligned, else 4.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
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

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Floats of one model slice in shared memory: means and var [D, L], then
// mu*var [D, L] (mxu), det [D], then c [D] (mxu), each rounded up to 4.
__host__ __device__ inline int k2_slice_floats(int D, int L, bool mxu) {
  const int dl = (D * L + 3) & ~3, d4 = (D + 3) & ~3;
  return (mxu ? 3 : 2) * dl + (mxu ? 2 : 1) * d4;
}

// K2's dynamic shared memory: the tile's features [L][NT] (and their
// squares, mxu), two model slices, the distances [NT][DG] (DG = D
// rounded up to a warp) and the running norms [NT].
__host__ __device__ inline size_t k2_smem_bytes(int D, int L, int NT,
                                                bool mxu) {
  const int DG = (D + 31) & ~31;
  return sizeof(float) * ((size_t)(mxu ? 2 : 1) * L * NT +
                          2 * (size_t)k2_slice_floats(D, L, mxu)) +
         sizeof(int32_t) * ((size_t)NT * DG + NT);
}

template <bool kMxu, int kL>
__global__ void __launch_bounds__(kK2Threads) dist_topn_norm_kernel(
    const float* __restrict__ feats, const float* __restrict__ means,
    const float* __restrict__ var_t, const float* __restrict__ det,
    const float* __restrict__ muv, const float* __restrict__ cst,
    int32_t* __restrict__ s_out, int32_t* __restrict__ cw_out, int N, int Cu,
    int F, int D, int L_rt, int topn, int NT) {
  extern __shared__ __align__(16) float smk[];
  constexpr bool kReg = kL > 0;
  const int L = kReg ? kL : L_rt;
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int DG = (D + 31) & ~31;
  const int G = blockDim.x / DG;  // groups of DG threads, frames split
  const int dl = round4(D * L), d4 = round4(D);
  const int slice = k2_slice_floats(D, L, kMxu);
  float* const xs = smk;                          // [L][NT]
  float* const xxs = xs + L * NT;                 // [L][NT] (mxu)
  float* const prm = xs + (kMxu ? 2 : 1) * L * NT;  // [2][slice]
  int32_t* const dist = reinterpret_cast<int32_t*>(prm + 2 * slice);  // [NT][DG]
  int32_t* const nrm = dist + NT * DG;            // [NT]

  auto stage_slice = [&](int c, float* dst) {
    const size_t cf = (size_t)c * F + f;
    stage(dst, means + cf * D * L, D * L);
    stage(dst + dl, var_t + cf * D * L, D * L);
    if (kMxu) {
      stage(dst + 2 * dl, muv + cf * D * L, D * L);
      stage(dst + 3 * dl, det + cf * D, D);
      stage(dst + 3 * dl + d4, cst + cf * D, D);
    } else {
      stage(dst + 2 * dl, det + cf * D, D);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage_slice(0, prm);
  // the tile's features of stream f, transposed; frames past N read 0
  for (int i = tid; i < L * NT; i += blockDim.x) {
    const int l = i / NT, q = i - l * NT;
    const int n = n0 + q;
    const float v = n < N ? feats[((size_t)n * F + f) * L + l] : 0.0f;
    xs[i] = v;
    if (kMxu) xxs[i] = __fmul_rn(v, v);
  }
  for (int q = tid; q < NT; q += blockDim.x) nrm[q] = INT_MIN;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int d = tid % DG;
  const int grp = tid / DG;
  for (int c = 0; c < Cu; ++c) {
    const float* const pm = prm + (c & 1) * slice;
    if (c + 1 < Cu) stage_slice(c + 1, prm + ((c + 1) & 1) * slice);
    // -- the distances of this thread's density, kK2Fold frames at a time --
    if (d < D && grp < G) {
      const float* const mu_s = pm + d * L;
      const float* const vr_s = pm + dl + d * L;
      const float* const mv_s = pm + 2 * dl + d * L;
      float mu_r[kReg ? kL : 1], vr_r[kReg ? kL : 1];
      if constexpr (kReg) {
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          mu_r[l] = kMxu ? mv_s[l] : mu_s[l];
          vr_r[l] = vr_s[l];
        }
      }
      const float dt = kMxu ? __fsub_rn(pm[3 * dl + d], pm[3 * dl + d4 + d])
                            : pm[2 * dl + d];
      for (int q0 = kK2Fold * grp; q0 < NT; q0 += kK2Fold * G) {
        float acc[kK2Fold], xv[kK2Fold], xmv[kK2Fold];
#pragma unroll
        for (int i = 0; i < kK2Fold; ++i) {
          acc[i] = dt;
          xv[i] = 0.0f;
          xmv[i] = 0.0f;
        }
        // dim l in order: mu the mean (fold) or mu*var (mxu), vr the var
        auto dim = [&](int l, float mu, float vr) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + l * NT + q0);
          const float x[kK2Fold] = {x4.x, x4.y, x4.z, x4.w};
          if (kMxu) {
            const float4 y4 =
                *reinterpret_cast<const float4*>(xxs + l * NT + q0);
            const float xx[kK2Fold] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
            for (int i = 0; i < kK2Fold; ++i) {
              xv[i] = __fmaf_rn(xx[i], vr, xv[i]);
              xmv[i] = __fmaf_rn(x[i], mu, xmv[i]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kK2Fold; ++i) {
              const float diff = __fsub_rn(x[i], mu);
              // acc - (diff * diff) * var, the product unrounded: the FMA
              // XLA's CPU backend makes of the JAX fold
              acc[i] = __fmaf_rn(-__fmul_rn(diff, diff), vr, acc[i]);
            }
          }
        };
        if constexpr (kReg) {
#pragma unroll
          for (int l = 0; l < kL; ++l) dim(l, mu_r[l], vr_r[l]);
        } else {
          for (int l = 0; l < L; ++l)
            dim(l, kMxu ? mv_s[l] : mu_s[l], vr_s[l]);
        }
#pragma unroll
        for (int i = 0; i < kK2Fold; ++i) {
          const float v = kMxu ? __fadd_rn(__fsub_rn(dt, xv[i]),
                                           __fmul_rn(2.0f, xmv[i]))
                               : acc[i];
          dist[(q0 + i) * DG + d] = int_dist(v);
        }
      }
    }
    __syncthreads();
    // -- top N of each frame: highest score, then lowest index; every
    // untaken density a candidate, INT_MIN included --
    // two frames a warp at a time (q and q + nwarps), so that the two
    // picks' reduction chains overlap
    for (int q0 = warp; q0 < NT && n0 + q0 < N; q0 += 2 * nwarps) {
      // each frame: this lane's densities lane + 32 k, sorted once:
      // highest score first, the lower index first on ties; absent
      // densities (index INT_MAX) last, never picked while a density is
      // left
      const int q1 = q0 + nwarps;
      const bool two = q1 < NT && n0 + q1 < N;  // warp-uniform
      int32_t v[2][kPerLane];
      int ix[2][kPerLane];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = u ? (two ? q1 : q0) : q0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int dd = lane + 32 * k;
          v[u][k] = dd < D ? dist[q * DG + dd] : INT_MIN;
          ix[u][k] = dd < D ? dd : INT_MAX;
        }
      }
      auto cswap = [&](int u, int i, int j) {  // (i, j) in order after
        const bool sw = v[u][j] > v[u][i] ||
                        (v[u][j] == v[u][i] && ix[u][j] < ix[u][i]);
        const int32_t vi = v[u][i], ii = ix[u][i];
        v[u][i] = sw ? v[u][j] : vi;
        ix[u][i] = sw ? ix[u][j] : ii;
        v[u][j] = sw ? vi : v[u][j];
        ix[u][j] = sw ? ii : ix[u][j];
      };
      static_assert(kPerLane == 4, "the sorting network sorts 4");
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        cswap(u, 0, 1);
        cswap(u, 2, 3);
        cswap(u, 0, 2);
        cswap(u, 1, 3);
        cswap(u, 1, 2);
      }
      int32_t my_s[2] = {0, 0}, my_c[2] = {0, 0};
      for (int j = 0; j < topn; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // the warp's best head, then the lowest index holding it
          const int32_t m = __reduce_max_sync(0xffffffffu, v[u][0]);
          const int idx = __reduce_min_sync(
              0xffffffffu, v[u][0] == m ? ix[u][0] : INT_MAX);
          if (ix[u][0] == idx) {  // this lane's head was taken: shift
#pragma unroll
            for (int k = 0; k + 1 < kPerLane; ++k) {
              v[u][k] = v[u][k + 1];
              ix[u][k] = ix[u][k + 1];
            }
            v[u][kPerLane - 1] = INT_MIN;
            ix[u][kPerLane - 1] = INT_MAX;
          }
          if (lane == j) {
            my_s[u] = m;
            my_c[u] = idx;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        const int q = u ? q1 : q0;
        const size_t o = (((size_t)(n0 + q) * Cu + c) * F + f) * topn;
        if (lane < topn) {
          s_out[o + lane] = my_s[u];
          cw_out[o + lane] = my_c[u];
        }
        // codebook_norm: the max over codebooks of the stream's top score
        if (lane == 0) nrm[q] = max(nrm[q], my_s[u] >> SST_SENSCR_SHIFT);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  // normalize this tile's raw top scores in place (this block's own
  // writes, visible to it after the barrier)
  const int per = Cu * topn;
  for (int i = tid; i < NT * per; i += blockDim.x) {
    const int q = i / per, r = i - q * per;
    const int n = n0 + q;
    if (n >= N) continue;
    const int c = r / topn, j = r - c * topn;
    const size_t o = (((size_t)n * Cu + c) * F + f) * topn + j;
    const int32_t sh = s_out[o] >> SST_SENSCR_SHIFT;
    s_out[o] = min(-(sh - nrm[q]), SST_MAX_NEG_ASCR);
  }
}

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// K3's dynamic shared memory: the weight rows [F*D][G + 4] (uint8), the
// term buffer of TB bytes ([sub][U][F*topn] uint16), the table
// zero-padded to kK3Tab, then
// the range's codebooks, the first occurrence and slot of each column,
// the distinct codebooks [G] each, and a count a warp.
inline size_t k3_smem_bytes(int F, int D, int G, int TB) {
  return (size_t)round16(F * D * (G + 4)) + round16(TB) +
         sizeof(int32_t) * ((size_t)kK3Tab + 4 * G + kK3Threads / 32);
}

// Rows of cnt <= G bytes, row i at src + i * S (any alignment), into
// dst + i * RS (RS = G + 4): a warp takes 32 / W rows at once (W = G / 4
// words a row), a lane a word, kK3Rows row groups a step with every load
// in flight before the first store.  Each destination word comes from
// the one or two aligned source words it spans (funnel shift); the
// second is read only where a byte of the row lies in it.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           int rows, int S, int cnt, int G) {
  const int W = G >> 2, RS = G + 4;
  const int lane = threadIdx.x & 31;
  const int k = lane & (W - 1);  // this lane's word
  const int step = (blockDim.x >> 5) * (32 / W);
  const bool need = 4 * k < cnt;
  for (int r0 = (threadIdx.x >> 5) * (32 / W) + lane / W; r0 < rows;
       r0 += kK3Rows * step) {
    uint32_t lo[kK3Rows], hi[kK3Rows];
    unsigned mis[kK3Rows];
#pragma unroll
    for (int u = 0; u < kK3Rows; ++u) {
      const int row = r0 + u * step;
      lo[u] = hi[u] = 0u;
      mis[u] = 0u;
      if (row < rows && need) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(src + (size_t)row * S);
        const uintptr_t p = a + 4 * k;
        mis[u] = (unsigned)(p & 3);
        const uint32_t* const q = reinterpret_cast<const uint32_t*>(p - mis[u]);
        lo[u] = __ldg(q);
        if (mis[u] && p - mis[u] + 4 < a + cnt) hi[u] = __ldg(q + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kK3Rows; ++u) {
      const int row = r0 + u * step;
      if (row < rows && need)
        reinterpret_cast<uint32_t*>(dst + row * RS)[k] =
            __funnelshift_r(lo[u], hi[u], 8 * mis[u]);
    }
  }
}

template <int kTopn, bool kWrap>
__global__ void __launch_bounds__(kK3Threads) senone_eval_kernel(
    const int32_t* __restrict__ s, const int32_t* __restrict__ cw,
    const uint8_t* __restrict__ mixw, const int32_t* __restrict__ cb_pos,
    const int32_t* __restrict__ table, int table_len, int32_t* __restrict__ out,
    int N, int Cu, int F, int D, int S, int G, int NT, int TB) {
  extern __shared__ __align__(16) uint8_t smb[];
  const int RS = G + 4;  // a weight row: G bytes, an odd number of words
  const int Fn = F * kTopn;
  uint8_t* const w = smb;  // [F * D][RS]
  uint16_t* const terms =
      reinterpret_cast<uint16_t*>(smb + round16(F * D * RS));  // [sub][U][Fn]
  int32_t* const tab = reinterpret_cast<int32_t*>(
      reinterpret_cast<uint8_t*>(terms) + round16(TB));
  int32_t* const cbs = tab + kK3Tab;     // [G] each column's codebook
  int32_t* const first = cbs + G;        // [G] its first occurrence
  int32_t* const slot = first + G;       // [G] its codebook's slot
  int32_t* const ucb = slot + G;         // [G] the distinct codebooks
  int32_t* const wcount = ucb + G;       // [warps] first occurrences a warp
  const int tid = threadIdx.x;
  // the ranges of one tile are neighbours in the grid, so they run
  // together and the tile's terms come from HBM once
  const int c0 = blockIdx.x * G;
  const int cnt = min(G, S - c0);
  const int t0 = blockIdx.y * NT;
  const int nt = min(NT, N - t0);

  stage_rows(w, mixw + c0, F * D, S, cnt, G);
  // the table, 0 past its end; the packed path reads it at
  // min(diff, kK3Tab - 1), which is 0 where table_len < kK3Tab
  for (int i = tid; i < kK3Tab; i += blockDim.x)
    tab[i] = i < table_len ? table[i] : 0;
  if (tid < G) cbs[tid] = tid < cnt ? cb_pos[c0 + tid] : -1;
  __syncthreads();
  // the range's distinct codebooks, in order of first occurrence
  bool head = false;
  if (tid < cnt) {
    const int cb = cbs[tid];
    int f0 = tid;
    for (int i = 0; i < tid; ++i)
      if (cbs[i] == cb) {
        f0 = i;
        break;
      }
    first[tid] = f0;
    head = f0 == tid;
  }
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if ((tid & 31) == 0) wcount[tid >> 5] = __popc(heads);
  __syncthreads();
  int U = 0, before = 0;
  for (int i = 0; i < kK3Threads / 32; ++i) {
    if (i == (tid >> 5)) before = U;
    U += wcount[i];
  }
  if (head) {
    const int u = before + __popc(heads & ((1u << (tid & 31)) - 1u));
    slot[tid] = u;
    ucb[u] = cbs[tid];
  }
  __syncthreads();
  const int j = tid % G;            // this thread's column
  const int H = kK3Threads / G;     // frames scored at once by a column
  const int h = tid / G;
  const int my_slot = j < cnt ? slot[first[j]] : -1;
  const uint8_t* const wj = w + j;
  int32_t* const oj = out + c0 + j;

  // the tile's frames in passes of as many as the term buffer holds for
  // the range's U codebooks
  const int sub = min(NT, TB / (2 * U * Fn));
  const int sl = my_slot;
  for (int n0 = t0; n0 < t0 + nt; n0 += sub) {
    const int nq = min(sub, t0 + nt - n0);
    if (n0 > t0) __syncthreads();  // the last pass's terms are read
    // the pass's terms: [q][u][f * topn + e], kK3Rows elements a step
    // with their loads in flight together; (q, u, e) of element i
    // advanced by the block's stride, no division
    bool wide = table_len >= kK3Tab;
    {
      const int per = U * Fn, total = nq * per;
      int q = tid / per, u = (tid % per) / Fn, e = tid % Fn;
      const int dq = kK3Threads / per, du = (kK3Threads % per) / Fn,
                de = kK3Threads % Fn;
      for (int i0 = tid; i0 < total; i0 += kK3Rows * kK3Threads) {
        int32_t sv[kK3Rows], cv[kK3Rows];
#pragma unroll
        for (int r = 0; r < kK3Rows; ++r) {
          sv[r] = 0;
          cv[r] = 0;
          if (i0 + r * kK3Threads < total) {
            const size_t src = ((size_t)(n0 + q) * Cu + ucb[u]) * Fn + e;
            sv[r] = __ldg(s + src);
            cv[r] = __ldg(cw + src);
          }
          e += de;
          if (e >= Fn) {
            e -= Fn;
            ++u;
          }
          u += du;
          if (u >= U) {
            u -= U;
            ++q;
          }
          q += dq;
        }
#pragma unroll
        for (int r = 0; r < kK3Rows; ++r) {
          const int i = i0 + r * kK3Threads;
          if (i < total) {
            wide |= (uint32_t)sv[r] > 511u;
            terms[i] = (uint16_t)(((uint32_t)sv[r] << 7) |
                                  ((uint32_t)cv[r] & 127u));
          }
        }
      }
    }
    wide = __syncthreads_or(wide);
    if (sl < 0) continue;  // a lane past the last range's columns
    if (!wide) {
      for (int qb = h; qb < nq; qb += H * kK3Ilp) {
        const uint16_t* t[kK3Ilp];
#pragma unroll
        for (int i = 0; i < kK3Ilp; ++i)
          t[i] = terms + (min(qb + i * H, nq - 1) * U + sl) * Fn;
        int32_t ascore[kK3Ilp] = {};
        for (int f = 0; f < F; ++f) {
          const uint8_t* const wf = wj + f * D * RS;
          int32_t fden[kK3Ilp] = {};
#pragma unroll
          for (int e = 0; e < kTopn; ++e) {
#pragma unroll
            for (int i = 0; i < kK3Ilp; ++i) {
              const int tv = t[i][f * kTopn + e];
              int32_t term = (int32_t)wf[(tv & 127) * RS] + (tv >> 7);
              if (kWrap) term &= 0xFF;
              if (e == 0) {
                fden[i] = term;
              } else {
                const int32_t diff = abs(fden[i] - term);
                fden[i] = min(fden[i], term) - tab[min(diff, kK3Tab - 1)];
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kK3Ilp; ++i) ascore[i] += fden[i];
        }
#pragma unroll
        for (int i = 0; i < kK3Ilp; ++i) {
          const int q = qb + i * H;
          if (q < nq) oj[(size_t)(n0 + q) * S] = ascore[i];
        }
      }
    } else {
      // an s outside the packed range, or a table past the staged one:
      // the terms from global memory, the table's end guarded
      const int cb = ucb[sl];
      for (int q = h; q < nq; q += H) {
        const size_t base = ((size_t)(n0 + q) * Cu + cb) * Fn;
        int32_t ascore = 0;
        for (int f = 0; f < F; ++f) {
          const uint8_t* const wf = wj + f * D * RS;
          int32_t fden = 0;
#pragma unroll
          for (int e = 0; e < kTopn; ++e) {
            const size_t qi = base + f * kTopn + e;
            int32_t term =
                (int32_t)((uint32_t)wf[cw[qi] * RS] + (uint32_t)s[qi]);
            if (kWrap) term &= 0xFF;
            if (e == 0) {
              fden = term;
            } else {
              const int32_t diff = fden > term ? fden - term : term - fden;
              fden = min(fden, term) - (diff < table_len ? table[diff] : 0);
            }
          }
          ascore += fden;
        }
        oj[(size_t)(n0 + q) * S] = ascore;
      }
    }
  }
}

// K3's columns a block: 128, or the widest of 64 and 32 whose last range
// leaves at most an eighth of the lanes of all ranges idle.
int k3_cols(int S) {
  for (int g = 128; g > 32; g /= 2) {
    const long span = (long)(S + g - 1) / g * g;
    if ((span - S) * 8 <= span) return g;
  }
  return 32;
}

// K3's frame tile: 128 frames, halved (down to 16) while the grid of
// ranges x ceil(N / tile) blocks would give an SM fewer than two blocks.
int k3_tile(int N, int S, int G, int sms) {
  const long ranges = (S + G - 1) / G;
  int tile = kK3TileMax;
  while (tile > 16 && (long)((N + tile - 1) / tile) * ranges < 2L * sms)
    tile /= 2;
  return tile;
}

// K3's term buffer in bytes: a tile's terms of min(Cu, G) codebooks, at
// most kK3TermBytes.
int k3_term_bytes(int Cu, int Fn, int G, int tile) {
  const long want = 2L * Fn * (Cu < G ? Cu : G) * tile;
  return (int)(want < kK3TermBytes ? want : kK3TermBytes);
}

// K2's frame tile for N frames of F streams on the current device: 64,
// halved (down to 16) while the grid of ceil(N / tile) x F blocks would
// give an SM fewer than two blocks.
cudaError_t k2_tile(int N, int F, int* tile) {
  int sms = 0;
  cudaError_t err = sst_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  *tile = 64;
  while (*tile > 16 && (long)((N + *tile - 1) / *tile) * F < 2L * sms)
    *tile /= 2;
  return err;
}

}  // namespace

// The tile sst_dist_topn_norm takes for N frames of F streams (for the
// logs); -1 where the device cannot be read.
extern "C" int sst_dist_topn_tile(int N, int F) {
  int tile = 0;
  return k2_tile(N, F, &tile) == cudaSuccess ? tile : -1;
}

extern "C" int sst_dist_topn_norm(const float* feats, const float* means,
                                  const float* var_t, const float* det,
                                  const float* muv, const float* c,
                                  int32_t* s, int32_t* cw, int N, int Cu,
                                  int F, int D, int L, int topn, int mxu,
                                  cudaStream_t stream) {
  if (D > SST_MAX_DENSITIES || topn > SST_MAX_TOPN || topn > D || topn < 1)
    return (int)cudaErrorInvalidValue;
  if (D < 1 || L < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0 || Cu <= 0) return (int)cudaSuccess;
  int tile = 0;
  const cudaError_t terr = k2_tile(N, F, &tile);
  if (terr != cudaSuccess) return (int)terr;
  const size_t smem = k2_smem_bytes(D, L, tile, mxu != 0);
  const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)F);
  const int threads = kK2Threads / ((D + 31) & ~31) * ((D + 31) & ~31);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, threads, smem, stream>>>(feats, means, var_t, det, muv, c,
                                            s, cw, N, Cu, F, D, L, topn,
                                            tile);
    return (int)cudaGetLastError();
  };
  if (L == kK2L)
    return mxu ? go(dist_topn_norm_kernel<true, kK2L>)
               : go(dist_topn_norm_kernel<false, kK2L>);
  return mxu ? go(dist_topn_norm_kernel<true, 0>)
             : go(dist_topn_norm_kernel<false, 0>);
}

extern "C" int sst_senone_eval_layout(int N, int S, int Cu, int F,
                                      int topn, int32_t* layout) {
  if (S < 1 || Cu < 1 || F < 1 || topn < 1 || topn > SST_MAX_TOPN)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sst_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return (int)err;
  const int G = k3_cols(S);
  const int tile = k3_tile(N, S, G, sms);
  const int tb = k3_term_bytes(Cu, F * topn, G, tile);
  const int most = Cu < G ? Cu : G;
  const int sub = tb / (2 * F * topn * most);
  layout[0] = G;
  layout[1] = tile;
  layout[2] = sub < tile ? sub : tile;
  return (int)cudaSuccess;
}

extern "C" int sst_senone_eval(const int32_t* s, const int32_t* cw,
                               const uint8_t* mixw, const int32_t* cb_pos,
                               const int32_t* table, int table_len,
                               int32_t* out, int N, int Cu, int F, int D,
                               int S, int topn, int wrap_u8,
                               cudaStream_t stream) {
  // a term packs cw into 7 bits; a pass holds a frame's terms of 128
  // codebooks
  if (topn < 1 || topn > SST_MAX_TOPN || D < 1 || D > SST_MAX_DENSITIES ||
      F < 1 || Cu < 1 || table_len < 0 || 256 * F * topn > kK3TermBytes)
    return (int)cudaErrorInvalidValue;
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  int32_t lay[3];
  cudaError_t err =
      (cudaError_t)sst_senone_eval_layout(N, S, Cu, F, topn, lay);
  if (err != cudaSuccess) return (int)err;
  const int G = lay[0], tile = lay[1];
  const int tb = k3_term_bytes(Cu, F * topn, G, tile);
  const size_t smem = k3_smem_bytes(F, D, G, tb);
  const dim3 grid((unsigned)((S + G - 1) / G),
                  (unsigned)((N + tile - 1) / tile));
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kK3Threads, smem, stream>>>(s, cw, mixw, cb_pos, table,
                                               table_len, out, N, Cu, F, D, S,
                                               G, tile, tb);
    return (int)cudaGetLastError();
  };
  auto by_wrap = [&](auto topn_c) {
    constexpr int kN = decltype(topn_c)::value;
    return wrap_u8 ? go(senone_eval_kernel<kN, true>)
                   : go(senone_eval_kernel<kN, false>);
  };
  switch (topn) {
    case 1: return by_wrap(std::integral_constant<int, 1>());
    case 2: return by_wrap(std::integral_constant<int, 2>());
    case 3: return by_wrap(std::integral_constant<int, 3>());
    case 4: return by_wrap(std::integral_constant<int, 4>());
    case 5: return by_wrap(std::integral_constant<int, 5>());
    case 6: return by_wrap(std::integral_constant<int, 6>());
    case 7: return by_wrap(std::integral_constant<int, 7>());
    default: return by_wrap(std::integral_constant<int, 8>());
  }
}
