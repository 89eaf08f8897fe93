// K8 `fe_spec`: pre-emphasis, framing, Hamming window, the reference's
// radix-2 real FFT, power spectrum and mel fold, in float64.
//
// Replaces the front half of the jitted XLA program B10 of the JAX
// package: soundswallower_tpu/fe/frontend.py Frontend._logspec_body up to
// the mel spectrum (with _fft_real and _mel_spec), which mfcc, mfcc_chunk
// and logspec_chunk run.
//
// Bound: float64 arithmetic and barriers.  One block owns one frame of
// one row: it stages the frame's nfft doubles in shared memory and runs
// fe_fft_real's in-place butterflies stage by stage (log2(nfft) stages,
// one barrier each; not cuFFT, whose rounding differs), so the
// per-element arithmetic is the C code's.  The block then folds the power
// spectrum into nfilt mel energies, one thread per filter, sequentially
// in coefficient order.  Frames and rows run in parallel, a block each.
//
// Rounding follows the JAX program on its CPU backend, whose compiler
// contracts a float64 multiply feeding an add into one FMA: the butterfly
// products, the power spectrum and the mel fold are __fma_rn in the same
// operand order; every other op rounds on its own (-fmad=false).
#include "sst_kernels.h"

namespace {

template <typename In>
__global__ void fe_spec_kernel(const In* __restrict__ sig,
                               const int32_t* __restrict__ n_samps,
                               const float* __restrict__ prior,
                               const double* __restrict__ window,
                               const int32_t* __restrict__ perm,
                               const double* __restrict__ ccc,
                               const double* __restrict__ sss,
                               const int32_t* __restrict__ spec_start,
                               const int32_t* __restrict__ widths,
                               const float* __restrict__ coeff,
                               double* __restrict__ out, int N, int T,
                               int shift, int size, int nfft, int log2n,
                               int nfilt, int maxw, double alpha) {
  extern __shared__ double sm[];
  double* fr = sm;          // [nfft] windowed frame, zero padded
  double* x = fr + nfft;    // [nfft] FFT work array
  double* spec = x + nfft;  // [nfft/2 + 1] power spectrum
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const In* s = sig + (size_t)b * N;
  const int ns = n_samps[b];

  // pre-emphasis (prior before sample 0; samples >= n_samps are zero),
  // framing and window
  for (int j = tid; j < nfft; j += nthr) {
    double v = 0.0;
    const int i = t * shift + j;
    if (j < size && i < N && i < ns) {
      const double cur = (double)(float)s[i];
      const double prev = i == 0 ? (double)prior[b] : (double)(float)s[i - 1];
      v = __dmul_rn(__fma_rn(-prev, alpha, cur), window[j]);
    }
    fr[j] = v;
  }
  __syncthreads();
  // bit reversal, then the 2-point stage (fe_sigproc.c:472-495)
  for (int i = tid; i < nfft / 2; i += nthr) {
    const double e = fr[perm[2 * i]];
    const double o = fr[perm[2 * i + 1]];
    x[2 * i] = __dadd_rn(e, o);
    x[2 * i + 1] = __dsub_rn(e, o);
  }
  __syncthreads();
  // stages k = 1 .. log2n-1: per block of 2^(k+1), item j = 0 does the
  // sum/difference and the negation, items j >= 1 a butterfly; no two
  // items of a stage touch one element
  for (int k = 1; k < log2n; ++k) {
    const int n4 = k - 1, n2 = k, n1 = k + 1;
    for (int q = tid; q < nfft / 4; q += nthr) {
      const int j = q & ((1 << n4) - 1);
      const int base = (q >> n4) << n1;
      if (j == 0) {
        const double xa = x[base], xb = x[base + (1 << n2)];
        x[base] = __dadd_rn(xa, xb);
        x[base + (1 << n2)] = __dsub_rn(xa, xb);
        x[base + (1 << n2) + (1 << n4)] = -x[base + (1 << n2) + (1 << n4)];
      } else {
        const int i1 = base + j, i2 = base + (1 << n2) - j;
        const int i3 = base + (1 << n2) + j, i4 = base + (1 << n1) - j;
        const int tw = j << (log2n - n1);
        const double cc = ccc[tw], ss = sss[tw];
        const double x1 = x[i1], x2 = x[i2], x3 = x[i3], x4 = x[i4];
        const double t1 = __fma_rn(x3, cc, __dmul_rn(x4, ss));
        const double t2 = __fma_rn(x3, ss, -__dmul_rn(x4, cc));
        x[i4] = __dsub_rn(x2, t2);
        x[i3] = __dsub_rn(-x2, t2);
        x[i2] = __dsub_rn(x1, t1);
        x[i1] = __dadd_rn(x1, t1);
      }
    }
    __syncthreads();
  }
  // power spectrum (fe_spec_magnitude)
  for (int j = tid; j <= nfft / 2; j += nthr) {
    spec[j] = j == 0 ? __dmul_rn(x[0], x[0])
                     : __fma_rn(x[j], x[j], __dmul_rn(x[nfft - j], x[nfft - j]));
  }
  __syncthreads();
  // mel fold: one thread per filter, coefficient order (fe_mel_spec)
  for (int i = tid; i < nfilt; i += nthr) {
    const int st = spec_start[i];
    const int w = widths[i];
    double acc = 0.0;
    for (int k = 0; k < w; ++k)
      acc = __fma_rn(spec[min(st + k, nfft / 2)], (double)coeff[i * maxw + k],
                     acc);
    out[((size_t)b * T + t) * nfilt + i] = acc;
  }
}

}  // namespace

extern "C" int sst_fe_spec(const void* sig, int sig_i16, const int32_t* n_samps,
                           const float* prior, const double* window,
                           const int32_t* perm, const double* ccc,
                           const double* sss, const int32_t* spec_start,
                           const int32_t* widths, const float* coeff,
                           double* out, int B, int N, int T, int shift,
                           int size, int nfft, int nfilt, int maxw,
                           double alpha, cudaStream_t stream) {
  if (nfft < 4 || (nfft & (nfft - 1)) || size > nfft || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  int log2n = 0;
  while ((1 << log2n) < nfft) ++log2n;
  const size_t smem = (size_t)(2 * nfft + nfft / 2 + 1) * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(T, B);
  if (sig_i16) {
    fe_spec_kernel<int16_t><<<grid, 128, smem, stream>>>(
        (const int16_t*)sig, n_samps, prior, window, perm, ccc, sss,
        spec_start, widths, coeff, out, N, T, shift, size, nfft, log2n, nfilt,
        maxw, alpha);
  } else {
    fe_spec_kernel<float><<<grid, 128, smem, stream>>>(
        (const float*)sig, n_samps, prior, window, perm, ccc, sss, spec_start,
        widths, coeff, out, N, T, shift, size, nfft, log2n, nfilt, maxw,
        alpha);
  }
  return (int)cudaGetLastError();
}
