// K10 `fe_cep`: log mel spectrum, DCT and lifter, frame-parallel.
//
// Replaces the back half of the jitted XLA program B10 of the JAX
// package: the log of soundswallower_tpu/fe/frontend.py
// Frontend._logspec_body (LOG_FLOOR 1e-4), Frontend._dct (fe_dct2 for
// dct/htk, fe_spec2cep for legacy) and the lifter of mfcc_chunk.
//
// Bound: the DCT's dependent float32 accumulations (ncep chains of nfilt
// float64 adds, each rounded to float32, as the C code's mfcc_t
// accumulator).  Frames are independent, so a block takes 8 frames: it
// puts their nfilt logs in shared memory once, then one thread per
// (frame, coefficient) runs that coefficient's chain.  Kept apart from
// K9 so the DCT never waits behind the noise scan's sequential frames.
//
// The float64 arithmetic is the JAX program's on its CPU backend: the
// product of a log and a basis value is contracted with the add that
// follows into an FMA; for legacy, XLA folds the factor 2 into the basis
// (exact) and divides by nfilt and 2*nfilt as a product with the
// reciprocal.  log is CUDA's double log.
#include "sst_kernels.h"

namespace {

constexpr int kFrames = 8;

__global__ void fe_cep_kernel(const double* __restrict__ mfspec,
                              const float* __restrict__ mel_cosine,
                              const float* __restrict__ lifter,
                              double* __restrict__ ls_out,
                              float* __restrict__ cep, int M, int nfilt,
                              int ncep, int kind, float scale0,
                              float sqrt_inv_2n) {
  extern __shared__ double ls[];  // [kFrames, nfilt]
  const int m0 = blockIdx.x * kFrames;
  const int nm = min(kFrames, M - m0);
  for (int q = threadIdx.x; q < nm * nfilt; q += blockDim.x) {
    const double v = log(__dadd_rn(mfspec[(size_t)m0 * nfilt + q], 1e-4));
    ls[q] = v;
    if (ls_out) ls_out[(size_t)m0 * nfilt + q] = v;
  }
  if (!cep) return;
  __syncthreads();
  const bool legacy = kind == 2;
  for (int q = threadIdx.x; q < nm * ncep; q += blockDim.x) {
    const int f = q / ncep;
    const int i = q - f * ncep;
    const double* l = ls + f * nfilt;
    float acc;
    float r;
    if (i == 0) {
      acc = (float)(legacy ? __dmul_rn(l[0], 0.5) : l[0]);
      for (int j = 1; j < nfilt; ++j) acc = (float)__dadd_rn((double)acc, l[j]);
      r = legacy ? (float)__dmul_rn((double)acc, __ddiv_rn(1.0, (double)nfilt))
                 : __fmul_rn(acc, scale0);
    } else {
      const float* mc = mel_cosine + i * nfilt;
      acc = 0.0f;
      for (int j = 0; j < nfilt; ++j) {
        const double b = (legacy && j) ? __dmul_rn((double)mc[j], 2.0)
                                       : (double)mc[j];
        acc = (float)__fma_rn(l[j], b, (double)acc);
      }
      r = legacy ? (float)__dmul_rn((double)acc,
                                    __ddiv_rn(1.0, 2.0 * (double)nfilt))
                 : __fmul_rn(acc, sqrt_inv_2n);
    }
    if (lifter) r = __fmul_rn(r, lifter[i]);
    cep[(size_t)(m0 + f) * ncep + i] = r;
  }
}

}  // namespace

extern "C" int sst_fe_cep(const double* mfspec, const float* mel_cosine,
                          const float* lifter, double* ls_out, float* cep,
                          int M, int nfilt, int ncep, int kind, float scale0,
                          float sqrt_inv_2n, cudaStream_t stream) {
  if (nfilt <= 0 || ncep <= 0 || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kFrames * nfilt * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  fe_cep_kernel<<<(M + kFrames - 1) / kFrames, 128, smem, stream>>>(
      mfspec, mel_cosine, lifter, ls_out, cep, M, nfilt, ncep, kind, scale0,
      sqrt_inv_2n);
  return (int)cudaGetLastError();
}
