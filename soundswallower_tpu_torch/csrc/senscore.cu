// K2 `dist_topn_norm` and K3 `senone_eval`: graph-restricted senone
// scoring.
//
// K2 replaces the jitted XLA programs B2 and the top-N/norm half of B3
// of the JAX package: soundswallower_tpu/ops/senscore_jax.py
// _dist_stage_graph (+ _int_dist) and _topn_sen_stage_graph (+
// _topn_argmax); over all codebooks (Cu = n_cb) also B7's _dist_stage
// and _topn_stage and the norm of _sen_eval, the function of the
// removed Pallas kernel P1 (tools/exp_pallas2.py dist_topn_fused2).  The TPU program wrote the [N, Cu, F, D] int32
// distance tensor to HBM between two dispatches; here it lives only in
// registers: each warp folds the 128 densities of one (frame, codebook,
// stream), picks its top N by warp argmax, and only the N winners and
// their scores leave the SM.  That fusion is what the removed Pallas
// kernel (tools/exp_pallas2.py) attempted.
// Bound: operations.  4*L float ops per density and frame; the model
// rows (Cu*F*D*L*8 bytes, about 1.6 MB at en-us width) stay in L2.
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

constexpr int kWarps = 8;  // K2 block: 8 warps, one (codebook, stream) each
constexpr int kPerLane = SST_MAX_DENSITIES / 32;
constexpr int kFramesPerBlock = 16;  // K3 block: frames sharing one table load

__device__ __forceinline__ int32_t int_dist(float d) {
  // XLA's convert truncates toward zero; _int_dist clamps below INT_MIN.
  // (cvt.rzi would saturate there too, but the clamp is the contract.)
  return d < -2147483648.0f ? INT_MIN : (int32_t)d;
}

template <bool kMxu>
__global__ void dist_topn_norm_kernel(
    const float* __restrict__ feats, const float* __restrict__ means,
    const float* __restrict__ var_t, const float* __restrict__ det,
    const float* __restrict__ muv, const float* __restrict__ cst,
    int32_t* __restrict__ s_out, int32_t* __restrict__ cw_out, int Cu, int F,
    int D, int L, int topn) {
  extern __shared__ int32_t sm[];
  float* x = reinterpret_cast<float*>(sm);  // [F, L] this frame
  float* xx = x + F * L;                    // [F, L] its squares (mxu form)
  int32_t* raw = sm + (kMxu ? 2 : 1) * F * L;  // [Cu, F, topn] raw top scores
  int32_t* norm = raw + Cu * F * topn;      // [F]
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < F * L; i += blockDim.x) {
    const float v = feats[(size_t)n * F * L + i];
    x[i] = v;
    if (kMxu) xx[i] = __fmul_rn(v, v);
  }
  __syncthreads();

  for (int pair = warp; pair < Cu * F; pair += kWarps) {
    const int f = pair % F;
    const size_t cf = (size_t)pair;  // == c * F + f
    const float* xf = x + f * L;
    const float* xxf = xx + f * L;
    int32_t v[kPerLane];
    unsigned taken = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = lane + 32 * k;
      v[k] = INT_MIN;
      if (d < D) {
        const float* mu = means + (cf * D + d) * L;
        const float* vr = var_t + (cf * D + d) * L;
        float acc = det[cf * D + d];
        if (kMxu) {
          const float* mv = muv + (cf * D + d) * L;
          float xv = 0.0f, xmv = 0.0f;
          for (int l = 0; l < L; ++l) {
            xv = __fmaf_rn(xxf[l], vr[l], xv);
            xmv = __fmaf_rn(xf[l], mv[l], xmv);
          }
          acc = __fadd_rn(__fsub_rn(__fsub_rn(acc, cst[cf * D + d]), xv),
                          __fmul_rn(2.0f, xmv));
        } else {
          for (int l = 0; l < L; ++l) {
            const float diff = __fsub_rn(xf[l], mu[l]);
            // acc - (diff * diff) * var, the product unrounded: the FMA
            // XLA's CPU backend makes of the JAX fold
            acc = __fmaf_rn(-__fmul_rn(diff, diff), vr[l], acc);
          }
        }
        v[k] = int_dist(acc);
      } else {
        taken |= 1u << k;  // no such density
      }
    }
    for (int j = 0; j < topn; ++j) {
      // this lane's best untaken density: highest score, lowest index
      int32_t bv = INT_MIN;
      int bi = INT_MAX;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (!(taken >> k & 1u) && (bi == INT_MAX || v[k] > bv)) {
          bv = v[k];
          bi = lane + 32 * k;
        }
      }
      // warp argmax, first max wins
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int32_t ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (oi != INT_MAX && (bi == INT_MAX || ov > bv || (ov == bv && oi < bi))) {
          bv = ov;
          bi = oi;
        }
      }
      if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
      if (lane == 0) {
        raw[cf * topn + j] = bv;
        cw_out[((size_t)n * Cu * F + cf) * topn + j] = bi;
      }
    }
  }
  __syncthreads();
  // codebook_norm: max over codebooks of each stream's top score
  if (tid < F) {
    int32_t m = INT_MIN;
    for (int c = 0; c < Cu; ++c) m = max(m, raw[(c * F + tid) * topn] >> SST_SENSCR_SHIFT);
    norm[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < Cu * F * topn; i += blockDim.x) {
    const int f = (i / topn) % F;
    const int32_t sh = raw[i] >> SST_SENSCR_SHIFT;
    s_out[(size_t)n * Cu * F * topn + i] = min(-(sh - norm[f]), SST_MAX_NEG_ASCR);
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

}  // namespace

extern "C" int sst_dist_topn_norm(const float* feats, const float* means,
                                  const float* var_t, const float* det,
                                  const float* muv, const float* c,
                                  int32_t* s, int32_t* cw, int N, int Cu,
                                  int F, int D, int L, int topn, int mxu,
                                  cudaStream_t stream) {
  if (D > SST_MAX_DENSITIES || topn > SST_MAX_TOPN || topn > D || topn < 1)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)((mxu ? 2 : 1) * F * L + Cu * F * topn + F) * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (mxu) {
    dist_topn_norm_kernel<true><<<N, 32 * kWarps, smem, stream>>>(
        feats, means, var_t, det, muv, c, s, cw, Cu, F, D, L, topn);
  } else {
    dist_topn_norm_kernel<false><<<N, 32 * kWarps, smem, stream>>>(
        feats, means, var_t, det, muv, c, s, cw, Cu, F, D, L, topn);
  }
  return (int)cudaGetLastError();
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
