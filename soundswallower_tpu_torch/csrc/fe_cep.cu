// K10 `fe_cep`: the log mel spectrum, or the log, DCT and lifter.
//
// Replaces the back half of the jitted XLA program B10 of the JAX
// package: the log of soundswallower_tpu/fe/frontend.py
// Frontend._logspec_body (LOG_FLOOR 1e-4), Frontend._dct (fe_dct2 for
// dct/htk, fe_spec2cep for legacy) and the lifter of mfcc_chunk.
//
// Two forms behind one launcher:
//
// * the log spectra (ls_out, no cep): bound by bytes, one float64 read
//   and one written per value.  A flat elementwise pass over the M x
//   nfilt values: 16-byte (double2) loads and stores where both arrays
//   are 16-byte aligned, two loads in flight per thread, a scalar tail,
//   grid-stride over a grid sized to fill every SM once; no shared
//   memory.
// * the cepstra (cep, no ls_out): bound by the DCT's dependent chains
//   (ncep chains of nfilt float64 FMAs per frame, each rounded to
//   float32, as the C code's mfcc_t accumulator).  A block takes
//   kFrames frames, so each of its threads owns one (frame,
//   coefficient) chain: it stages the frames' logs in shared memory
//   with 16-byte loads (scalar ones where the block's first frame is
//   not 16-byte aligned), and the basis (mel_cosine, transposed, in
//   float64, legacy's factor 2 folded in) once per block.  The first
//   coefficient's plain sum runs as the same chain with a basis of 1
//   (an FMA by 1 rounds as the add), so no warp splits.
//
// The float64 arithmetic is the JAX program's on its CPU backend: the
// product of a log and a basis value is contracted with the add that
// follows into an FMA; for legacy, XLA folds the factor 2 into the basis
// (exact) and divides by nfilt and 2*nfilt as a product with the
// reciprocal.  log is CUDA's double log.
#include <algorithm>

#include "sst_kernels.h"

namespace {

constexpr int kLogThreads = 256;
constexpr int kUnroll = 2;       // 16-byte loads a thread keeps in flight
constexpr int kFrames = 32;      // frames per block of the DCT form

__device__ __forceinline__ double log_floor(double x) {
  return log(__dadd_rn(x, 1e-4));
}

__global__ void __launch_bounds__(kLogThreads)
fe_cep_log_kernel(const double* __restrict__ in, double* __restrict__ out,
                  int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * kLogThreads;
  const int64_t i0 = (int64_t)blockIdx.x * kLogThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    // kUnroll 16-byte loads in flight before their logs
    const double2* in2 = reinterpret_cast<const double2*>(in);
    double2* out2 = reinterpret_cast<double2*>(out);
    const int64_t n2 = n >> 1;
    for (int64_t k = i0; k < n2; k += kUnroll * stride) {
      double2 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + u * stride < n2) v[u] = in2[k + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + u * stride < n2)
          out2[k + u * stride] = make_double2(log_floor(v[u].x),
                                              log_floor(v[u].y));
    }
    done = n2 << 1;
  }
  for (int64_t k = done + i0; k < n; k += stride) out[k] = log_floor(in[k]);
}

__global__ void __launch_bounds__(1024)
fe_cep_dct_kernel(const double* __restrict__ mfspec,
                  const float* __restrict__ mel_cosine,
                  const float* __restrict__ lifter, float* __restrict__ cep,
                  int M, int nfilt, int ncep, int frames, int legacy,
                  float scale0, float sqrt_inv_2n) {
  extern __shared__ double smem[];
  double* ls = smem;                        // [frames, nfilt]
  double* bas = ls + frames * nfilt;        // [nfilt, ncep]
  const int m0 = blockIdx.x * frames;
  const int nm = min(frames, M - m0);
  const int n = nm * nfilt;
  const double* src = mfspec + (size_t)m0 * nfilt;
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    const double2* src2 = reinterpret_cast<const double2*>(src);
    for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
      const double2 v = src2[k];
      ls[2 * k] = log_floor(v.x);
      ls[2 * k + 1] = log_floor(v.y);
    }
    done = n & ~1;
  }
  for (int k = done + threadIdx.x; k < n; k += blockDim.x)
    ls[k] = log_floor(src[k]);
  for (int k = threadIdx.x; k < nfilt * ncep; k += blockDim.x) {
    const int j = k / ncep;
    const int i = k - j * ncep;
    double b;
    if (i == 0)
      b = (legacy && j == 0) ? 0.5 : 1.0;
    else
      b = (legacy && j) ? __dmul_rn((double)mel_cosine[i * nfilt + j], 2.0)
                        : (double)mel_cosine[i * nfilt + j];
    bas[k] = b;
  }
  __syncthreads();
  const int f = threadIdx.x / ncep;
  const int i = threadIdx.x - f * ncep;
  if (f >= nm) return;
  const double* l = ls + f * nfilt;
  float acc = 0.0f;
  for (int j = 0; j < nfilt; ++j)
    acc = (float)__fma_rn(l[j], bas[j * ncep + i], (double)acc);
  float r;
  if (legacy)
    r = (float)__dmul_rn((double)acc,
                         __ddiv_rn(1.0, (i ? 2.0 : 1.0) * (double)nfilt));
  else
    r = __fmul_rn(acc, i ? sqrt_inv_2n : scale0);
  if (lifter) r = __fmul_rn(r, lifter[i]);
  cep[(size_t)(m0 + f) * ncep + i] = r;
}

}  // namespace

extern "C" int sst_fe_cep(const double* mfspec, const float* mel_cosine,
                          const float* lifter, double* ls_out, float* cep,
                          int M, int nfilt, int ncep, int kind, float scale0,
                          float sqrt_inv_2n, cudaStream_t stream) {
  if (nfilt <= 0 || ncep <= 0 || ncep > 1024 || kind < 0 || kind > 2
      || (ls_out == nullptr) == (cep == nullptr))
    return (int)cudaErrorInvalidValue;
  const int frames = std::min(kFrames, 1024 / ncep);
  const size_t smem = ((size_t)frames * nfilt + (size_t)nfilt * ncep)
                      * sizeof(double);
  if (cep && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  if (ls_out) {
    const int64_t n = (int64_t)M * nfilt;
    const int vec = (((uintptr_t)mfspec | (uintptr_t)ls_out) & 15) == 0;
    const int64_t per = vec ? 2 * kUnroll : 1;   // values a thread's step
    const int64_t need = (n + per * kLogThreads - 1) / (per * kLogThreads);
    static const int fill = sst_fill_blocks(fe_cep_log_kernel, kLogThreads);
    const int blocks = (int)std::min<int64_t>(std::max<int64_t>(need, 1),
                                              fill);
    fe_cep_log_kernel<<<blocks, kLogThreads, 0, stream>>>(mfspec, ls_out, n,
                                                          vec);
  } else {
    const int threads = (frames * ncep + 31) / 32 * 32;
    fe_cep_dct_kernel<<<(M + frames - 1) / frames, threads, smem, stream>>>(
        mfspec, mel_cosine, lifter, cep, M, nfilt, ncep, frames, kind == 2,
        scale0, sqrt_inv_2n);
  }
  return (int)cudaGetLastError();
}
