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
// packed with the density index, which is the key here too (so -0.0
// ranks below +0.0, as there).  A distance below WORST_DIST (INT_MIN as
// a float) gets key -1 and comes out as (WORST_DIST, 0).  With
// n_best == D (topn >= D) every density is written in index order,
// unsorted (compute_dist_all).  The TPU program wrote the [N, C, F, D]
// float tensor to HBM (2.6 GB per 128-row chunk at en-us width); here
// each warp folds the densities of one (frame, codebook, stream) in
// registers and only the N winners leave the SM.
// Bound: operations, 4*L float ops per density and frame (the fold).
//
// K12 replaces the rest of _ms_stage (ms_senone.c senone_eval,
// ms_mgau.c's best subtraction): one block per frame over all S
// senones.  Per senone and stream: fden = the rounded-up SENSCR_SHIFT
// shift of the int64 truncation of each top distance (INT_MIN >> shift
// at the floor), minus the senone's quantized weight of that density;
// the full logmath_add over the N terms on the 8-bit table (read as
// d < len ? table[d] : 0) with both zero guards; the negated int64 sum
// over streams; the acoustic weight's truncation toward zero; the int16
// clamp.  Pass 1 writes each clamped score (it fits int16) and the block
// takes the frame's minimum; pass 2 rereads its own scores, subtracts
// the minimum, clamps again.  Out int16 [N, S] in senone order.
// Bound: the int16 output and the mixture-weight gathers
// (F*N 4-byte reads per (frame, senone), from L2).
#include <climits>

#include "sst_kernels.h"

namespace {

constexpr int kWarps = 8;  // K11 block: 8 warps, one (codebook, stream) each
constexpr int kPerLane = SST_MAX_DENSITIES / 32;
constexpr int kThreads = 256;  // K12 block
constexpr float kWorstDist = -2147483648.0f;

__device__ __forceinline__ long long order_key(float d, int idx, int D) {
  // the JAX program's key: the float's bits as an unsigned order, times
  // D, plus the density index; -1 below the WORST_DIST floor
  if (d < kWorstDist) return -1;
  const unsigned int u = __float_as_uint(d);
  const unsigned long long k =
      (u & 0x80000000u) ? (unsigned long long)(~u) : (unsigned long long)u | 0x80000000ull;
  return (long long)(k * (unsigned long long)D) + idx;
}

__global__ void ms_dist_topn_kernel(
    const float* __restrict__ feats, const float* __restrict__ means,
    const float* __restrict__ var_t, const float* __restrict__ det,
    float* __restrict__ dval_out, int32_t* __restrict__ cw_out, int C, int F,
    int D, int L, int ne) {
  extern __shared__ float x[];  // [F, L] this frame
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < F * L; i += blockDim.x) x[i] = feats[(size_t)n * F * L + i];
  __syncthreads();

  for (int pair = warp; pair < C * F; pair += kWarps) {
    const int f = pair % F;
    const size_t cf = (size_t)pair;  // == c * F + f
    const float* xf = x + f * L;
    const size_t base = ((size_t)n * C * F + cf) * ne;
    float v[kPerLane];
    long long key[kPerLane];
    unsigned taken = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = lane + 32 * k;
      v[k] = 0.0f;
      key[k] = LLONG_MIN;
      if (d < D) {
        const float* mu = means + (cf * D + d) * L;
        const float* vr = var_t + (cf * D + d) * L;
        float acc = det[cf * D + d];
        for (int l = 0; l < L; ++l) {
          const float diff = __fsub_rn(xf[l], mu[l]);
          acc = __fmaf_rn(-__fmul_rn(diff, diff), vr[l], acc);
        }
        v[k] = acc;
        key[k] = order_key(acc, d, D);
      } else {
        taken |= 1u << k;  // no such density
      }
    }
    if (ne >= D) {
      // every density in index order, unsorted, no floor
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int d = lane + 32 * k;
        if (d < D) {
          dval_out[base + d] = v[k];
          cw_out[base + d] = d;
        }
      }
      continue;
    }
    for (int j = 0; j < ne; ++j) {
      // this lane's best untaken density: highest key, lowest index
      long long bk = LLONG_MIN;
      int bi = INT_MAX;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (!(taken >> k & 1u) && (bi == INT_MAX || key[k] > bk)) {
          bk = key[k];
          bi = lane + 32 * k;
        }
      }
      // warp argmax; keys are distinct except the floor's -1, where the
      // lowest index wins (as lax.top_k's)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const long long ok = __shfl_xor_sync(0xffffffffu, bk, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (oi != INT_MAX && (bi == INT_MAX || ok > bk || (ok == bk && oi < bi))) {
          bk = ok;
          bi = oi;
        }
      }
      if ((bi & 31) == lane) {
        const int kk = bi >> 5;
        taken |= 1u << kk;
        float val = v[0];
#pragma unroll
        for (int k = 1; k < kPerLane; ++k)
          if (k == kk) val = v[k];
        const bool bad = bk < 0;
        dval_out[base + j] = bad ? kWorstDist : val;
        cw_out[base + j] = bad ? 0 : bi;
      }
    }
  }
}

__device__ __forceinline__ long long ms_logadd(long long x, long long y, const int32_t* tab,
                                               int table_len, long long zero) {
  // logmath_add with the JAX program's guards (senscore_jax.py:373-383)
  const long long r = x > y ? x : y;
  const long long d = r - (x > y ? y : x);
  long long res = r + (d < table_len ? tab[d] : 0);
  if (x <= zero) res = y;
  if (y <= zero) res = x <= zero ? res : x;
  return res;
}

__global__ void ms_senone_eval_kernel(
    const float* __restrict__ dval, const int32_t* __restrict__ cw,
    const int32_t* __restrict__ mixw, const int32_t* __restrict__ sen2cb,
    const int32_t* __restrict__ table, int table_len, int16_t* __restrict__ out,
    int C, int F, int D, int S, int ne, int zero8, int aw) {
  extern __shared__ int32_t tab[];
  __shared__ int32_t wmin[kThreads / 32];
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int n = blockIdx.x;
  const long long zero = zero8;
  const long long floor_den = (long long)INT_MIN >> SST_SENSCR_SHIFT;
  int16_t* orow = out + (size_t)n * S;
  int32_t m = INT32_MAX;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const size_t cb = (size_t)sen2cb[s];
    long long sum = 0;
    for (int f = 0; f < F; ++f) {
      const size_t q0 = (((size_t)n * C + cb) * F + f) * ne;
      const int32_t* w = mixw + ((size_t)s * F + f) * D;
      long long fscr = 0;
      for (int j = 0; j < ne; ++j) {
        const float dv = dval[q0 + j];
        const long long fden =
            dv < kWorstDist ? floor_den
                            : ((long long)dv + ((1 << SST_SENSCR_SHIFT) - 1)) >> SST_SENSCR_SHIFT;
        const long long fw = fden - (long long)w[cw[q0 + j]];
        fscr = j == 0 ? fw : ms_logadd(fscr, fw, tab, table_len, zero);
      }
      sum += fscr;
    }
    long long scr = -sum;
    if (aw != 1) scr = scr < 0 ? -((-scr) / aw) : scr / aw;
    scr = scr < -32768 ? -32768 : (scr > 32767 ? 32767 : scr);
    orow[s] = (int16_t)scr;
    m = min(m, (int32_t)scr);
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = m;
  __syncthreads();
  m = INT32_MAX;
  for (int w = 0; w < kThreads / 32; ++w) m = min(m, wmin[w]);
  for (int s = threadIdx.x; s < S; s += kThreads) {
    int32_t v = (int32_t)orow[s] - m;  // this thread's own pass-1 write
    v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
    orow[s] = (int16_t)v;
  }
}

}  // namespace

extern "C" int sst_ms_dist_topn(const float* feats, const float* means,
                                const float* var_t, const float* det,
                                float* dval, int32_t* cw, int N, int C, int F,
                                int D, int L, int ne, cudaStream_t stream) {
  if (D > SST_MAX_DENSITIES || ne < 1 || ne > D) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)F * L * sizeof(float);
  ms_dist_topn_kernel<<<N, 32 * kWarps, smem, stream>>>(feats, means, var_t, det,
                                                         dval, cw, C, F, D, L, ne);
  return (int)cudaGetLastError();
}

extern "C" int sst_ms_senone_eval(const float* dval, const int32_t* cw,
                                  const int32_t* mixw, const int32_t* sen2cb,
                                  const int32_t* table, int table_len,
                                  int16_t* out, int N, int C, int F, int D,
                                  int S, int ne, int zero8, int aw,
                                  cudaStream_t stream) {
  if (aw < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  ms_senone_eval_kernel<<<N, kThreads, table_len * sizeof(int32_t), stream>>>(
      dval, cw, mixw, sen2cb, table, table_len, out, C, F, D, S, ne, zero8, aw);
  return (int)cudaGetLastError();
}
