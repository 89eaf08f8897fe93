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
// a one-hot bf16 matmul on the MXU; here each thread gathers them
// directly from the [F, D, S] uint8 table and does the 8-bit log-add
// with a table in shared memory, which equals the TPU's staircase sum
// (ScorerTables.from_am asserts the staircase rebuilds the table).
// Bound: gathers, 2*F*topn 4-byte reads + F*topn byte reads per
// (frame, state).
//
// Both are bit-equal to the JAX programs: the fold is rounded as XLA's
// CPU backend rounds it (each step one fused multiply-add of the rounded
// square, written out with intrinsics; built with -fmad=false so that
// nothing else contracts), float->int truncates with an explicit
// INT_MIN clamp, and every tie goes to the lowest index.  K3 at the
// full inventory (S = n_sen, cb_pos = sen2cb) is B7's mixture eval.
#include <climits>

#include "sst_kernels.h"

namespace {

constexpr int kPerLane = SST_MAX_DENSITIES / 32;
constexpr int kFramesPerBlock = 16;  // K3 block: frames sharing one table load
constexpr int kK2Threads = 256;      // K2 block
constexpr int kK2Fold = 4;           // frames a K2 thread folds at once
constexpr int kK2L = 13;             // the dims whose model rows sit in registers

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

__global__ void senone_eval_kernel(
    const int32_t* __restrict__ s, const int32_t* __restrict__ cw,
    const uint8_t* __restrict__ mixw, const int32_t* __restrict__ cb_pos,
    const int32_t* __restrict__ table, int table_len, int32_t* __restrict__ out,
    int N, int Cu, int F, int D, int S, int topn, int wrap_u8) {
  extern __shared__ int32_t tab[];
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int n0 = blockIdx.x * kFramesPerBlock;
  const int nf = min(kFramesPerBlock, N - n0);
  for (int i = threadIdx.x; i < nf * S; i += blockDim.x) {
    const int n = n0 + i / S;
    const int st = i % S;
    const size_t base = ((size_t)n * Cu + cb_pos[st]) * F * topn;
    int32_t ascore = 0;
    for (int f = 0; f < F; ++f) {
      int32_t fden = 0;
      for (int j = 0; j < topn; ++j) {
        const size_t q = base + (size_t)f * topn + j;
        int32_t term = (int32_t)mixw[((size_t)f * D + cw[q]) * S + st] + s[q];
        if (wrap_u8) term &= 0xFF;
        if (j == 0) {
          fden = term;
        } else {
          const int32_t diff = fden > term ? fden - term : term - fden;
          fden = min(fden, term) - (diff < table_len ? tab[diff] : 0);
        }
      }
      ascore += fden;
    }
    out[(size_t)n * S + st] = ascore;
  }
}

// K2's frame tile for N frames of F streams on the current device: 64,
// halved (down to 16) while the grid of ceil(N / tile) x F blocks would
// give an SM fewer than two blocks.
cudaError_t k2_tile(int N, int F, int* tile) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

extern "C" int sst_senone_eval(const int32_t* s, const int32_t* cw,
                               const uint8_t* mixw, const int32_t* cb_pos,
                               const int32_t* table, int table_len,
                               int32_t* out, int N, int Cu, int F, int D,
                               int S, int topn, int wrap_u8,
                               cudaStream_t stream) {
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  const int blocks = (N + kFramesPerBlock - 1) / kFramesPerBlock;
  senone_eval_kernel<<<blocks, 256, table_len * sizeof(int32_t), stream>>>(
      s, cw, mixw, cb_pos, table, table_len, out, N, Cu, F, D, S, topn,
      wrap_u8);
  return (int)cudaGetLastError();
}
