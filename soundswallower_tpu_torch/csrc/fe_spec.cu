// K8 `fe_spec`: pre-emphasis, framing, the frame mean (remove_dc),
// Hamming window, the reference's radix-2 real FFT, power spectrum and
// mel fold, in float64.
//
// Replaces the front half of the jitted XLA program B10 of the JAX
// package: soundswallower_tpu/fe/frontend.py Frontend._logspec_body up to
// the mel spectrum (with _fft_real and _mel_spec), which mfcc, mfcc_chunk
// and logspec_chunk run.
//
// Bound: shared-memory traffic, then float64 arithmetic.  A block owns W
// consecutive frames of one row (sst_fe_spec_frames: about 16 KB of FFT
// buffers, 8 frames at nfft 256, 4 at 512), a warp a frame:
//
// * the block stages its tables (window, twiddles by stage, mel filters)
//   and its span of (W - 1) * shift + size samples in shared memory once,
//   pre-emphasising each sample once, where neighbouring frames share
//   most of their samples;
// * each warp runs fe_fft_real (not cuFFT, whose rounding differs) in
//   passes through registers.  Pass 0: each lane gathers a chunk of C
//   (up to 16) consecutive bit-reversed inputs straight from the span
//   times the window (the bit reversal computed, so the gather is
//   conflict-free) and runs the 2-point stage and stages 1 .. log2(C)-1
//   in registers.  Later passes cover up to log2(C)-1 stages each: stage
//   k only mixes elements within blocks of 2^(k+1), and item j of stage
//   k, in both halves of a block of stage k+1, touches exactly the
//   elements that items j and 2^k - j of stage k+1 touch; so a lane loads
//   such a closed set of C elements (of item j or, for j = 0, the
//   multiples of 2^(k-1)), runs its stages in registers and stores it
//   back.  Each element's arithmetic is the C code's, in stage order, so
//   the bits are the same; shared memory holds the frame between passes,
//   its index swizzled (swz) so that the passes' accesses spread over the
//   banks; __syncwarp between passes.  Then the power spectrum, in place;
// * after one block barrier the W x nfilt mel chains are spread over the
//   block, each a thread's serial fold in coefficient order, and the
//   block writes its W x nfilt contiguous outputs.
//
// Rounding follows the JAX program on its CPU backend, whose compiler
// contracts a float64 multiply feeding an add into one FMA: the butterfly
// products, the power spectrum and the mel fold are __fma_rn in the same
// operand order; every other op rounds on its own (-fmad=false).
//
// remove_dc (frontend.py:513-515) subtracts the frame mean before the
// window.  XLA's CPU backend rewrites that frame sum as a tree: windows
// of 32 values (the frame zero-padded to whole windows, half the padding
// in front), each added in order from 0, then the window sums reduced the
// same way; the mean is the sum times 1/size, fused into the subtraction.
// The warp adds its frame's windows from the span, a lane each, level by
// level in that order, in its nfft buffer before the FFT fills it
// (fe/frontend.py frame_sum_plain is the plain version).
#include "sst_kernels.h"

namespace {

constexpr int kSumWindow = 32;
constexpr int kMaxFrames = 16;         // W: frames (warps) a block
constexpr int kFftBytes = 16 * 1024;   // the W FFT buffers' target size

// XLA's tree order for the float64 sum of x[0..n) (see above), by one
// warp; two scratch areas of at least (n + 31) / 32 doubles, distinct
// from x.  The result is valid in every lane.
__device__ double warp_frame_sum(const double* x, int n, double* scratch_a,
                                 double* scratch_b, int lane) {
  const double* src = x;
  double* dst = scratch_a;
  while (n > kSumWindow) {
    const int nwin = (n + kSumWindow - 1) / kSumWindow;
    const int lo = (nwin * kSumWindow - n) / 2;
    for (int w = lane; w < nwin; w += 32) {
      double acc = 0.0;
      for (int k = 0; k < kSumWindow; ++k) {
        const int i = w * kSumWindow + k - lo;
        acc = __dadd_rn(acc, i >= 0 && i < n ? src[i] : 0.0);
      }
      dst[w] = acc;
    }
    __syncwarp();
    src = dst;
    dst = dst == scratch_a ? scratch_b : scratch_a;
    n = nwin;
  }
  double acc = 0.0;
  for (int i = 0; i < n; ++i) acc = __dadd_rn(acc, src[i]);
  __syncwarp();  // the scratch may be reused once every lane has read
  return acc;
}

// The frame buffer's element i at swz(i): its low 4 bits XORed with bits
// 3-7, so that the passes' strided sets fall in distinct banks (a
// bijection within each run of 16 elements).
__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 3) ^ (i >> 4)) & 15);
}

// One butterfly of fe_fft_real (fe_sigproc.c:530-550) on registers.
__device__ __forceinline__ void butterfly(double& x1, double& x2, double& x3,
                                          double& x4, double c, double s) {
  const double t1 = __fma_rn(x3, c, __dmul_rn(x4, s));
  const double t2 = __fma_rn(x3, s, -__dmul_rn(x4, c));
  const double a1 = x1, a2 = x2;
  x4 = __dsub_rn(a2, t2);
  x3 = __dsub_rn(-a2, t2);
  x2 = __dsub_rn(a1, t1);
  x1 = __dadd_rn(a1, t1);
}

// Item 0 of a stage: sum and difference, and the negation at 2^n2 + 2^n4.
__device__ __forceinline__ void item0(double& xa, double& xb, double& xc) {
  const double a = xa, b = xb;
  xa = __dadd_rn(a, b);
  xb = __dsub_rn(a, b);
  xc = -xc;
}

// Pass 0: the gather, the 2-point stage and stages 1 .. M on chunks of
// C = 2^(M+1) consecutive elements, a chunk a lane.  pc/ps: twiddles of
// stage k at (1 << (k-1)) + j.
template <int M>
__device__ void fft_pass0(double* x, const double* fr, const double* win,
                          int size, int remove_dc, double sum, double inv,
                          int nfft, int log2n, const double* pc,
                          const double* ps, int lane) {
  constexpr int C = 2 << M;
  for (int g = lane; g < nfft / C; g += 32) {
    double v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int j = (int)(__brev((unsigned)(g * C + r)) >> (32 - log2n));
      v[r] = j >= size ? 0.0
             : remove_dc ? __dmul_rn(__fma_rn(-sum, inv, fr[j]), win[j])
                         : __dmul_rn(fr[j], win[j]);
    }
#pragma unroll
    for (int r = 0; r < C; r += 2) {
      const double e = v[r], o = v[r + 1];
      v[r] = __dadd_rn(e, o);
      v[r + 1] = __dsub_rn(e, o);
    }
#pragma unroll
    for (int k = 1; k <= M; ++k) {
      const int h = 1 << k, q4 = h >> 1;  // 2^n2, 2^n4
#pragma unroll
      for (int blk = 0; blk < C; blk += 2 * h) {
        item0(v[blk], v[blk + h], v[blk + h + q4]);
#pragma unroll
        for (int j = 1; j < q4; ++j)
          butterfly(v[blk + j], v[blk + h - j], v[blk + h + j],
                    v[blk + 2 * h - j], pc[q4 + j], ps[q4 + j]);
      }
    }
#pragma unroll
    for (int r = 0; r < C; ++r) x[swz(g * C + r)] = v[r];
  }
}

// A pass over stages k0 .. k0+M-1: each lane takes seeds g (block b,
// item j of stage k0), loads the seed's 2^(M+1) elements, runs the
// stages in registers and stores them.  Item j >= 1: the elements j,
// 2^k0 - j, 2^k0 + j, 2^(k0+1) - j, doubled by each later stage into the
// block's other half; at stage k0+t they form groups of 4 << t whose
// halves X, Y pair X[p], X[h-1-p], Y[p], Y[h-1-p].  Item 0: the multiples
// of 2^(k0-1), on which each stage is the original stage at that stride.
template <int M>
__device__ void fft_pass(double* x, int k0, int nfft, int log2n,
                         const double* pc, const double* ps, int lane) {
  constexpr int C = 2 << M;
  for (int g = lane; g < (nfft >> (M + 1)); g += 32) {
    const int j = g & ((1 << (k0 - 1)) - 1);
    const int base = (g >> (k0 - 1)) << (k0 + M);
    int idx[C];
    if (j == 0) {
#pragma unroll
      for (int q = 0; q < C; ++q) idx[q] = base + (q << (k0 - 1));
    } else {
      idx[0] = base + j;
      idx[1] = base + (1 << k0) - j;
      idx[2] = base + (1 << k0) + j;
      idx[3] = base + (2 << k0) - j;
#pragma unroll
      for (int t = 1; t < M; ++t)
#pragma unroll
        for (int e = 0; e < (2 << t); ++e)
          idx[e + (2 << t)] = idx[e] + (1 << (k0 + t));
    }
    double v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) v[r] = x[swz(idx[r])];
    if (j == 0) {
#pragma unroll
      for (int t = 0; t < M; ++t) {
        const int K = k0 + t, bk = 4 << t;
#pragma unroll
        for (int G = 0; G < C; G += bk) {
          item0(v[G], v[G + bk / 2], v[G + bk / 2 + bk / 4]);
#pragma unroll
          for (int q = 1; q < bk / 4; ++q) {
            const int tw = (1 << (K - 1)) + (q << (k0 - 1));
            butterfly(v[G + q], v[G + bk / 2 - q], v[G + bk / 2 + q],
                      v[G + bk - q], pc[tw], ps[tw]);
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < M; ++t) {
        const int K = k0 + t, gs = 4 << t, h = gs / 2;
#pragma unroll
        for (int G = 0; G < C; G += gs) {
#pragma unroll
          for (int p = 0; p < h / 2; ++p) {
            const int tw = (1 << (K - 1)) + (idx[G + p] & ((2 << K) - 1));
            butterfly(v[G + p], v[G + h - 1 - p], v[G + h + p],
                      v[G + gs - 1 - p], pc[tw], ps[tw]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < C; ++r) x[swz(idx[r])] = v[r];
  }
}

// fe_fft_real on one warp's frame buffer x (swizzled), from the frame fr
// times the window: chunks of C = 2^(M+1) = min(nfft / 32, 16) elements
// (at least 4), M stages a pass.
template <int M>
__device__ void warp_fft(double* x, const double* fr, const double* win,
                         int size, int remove_dc, double sum, double inv,
                         int nfft, int log2n, const double* pc,
                         const double* ps, int lane) {
  fft_pass0<M>(x, fr, win, size, remove_dc, sum, inv, nfft, log2n, pc, ps,
               lane);
  __syncwarp();
  for (int k0 = M + 1; k0 < log2n; k0 += M) {
    const int mp = log2n - k0 < M ? log2n - k0 : M;
    if (M >= 3 && mp == 3)
      fft_pass<(M >= 3 ? 3 : 1)>(x, k0, nfft, log2n, pc, ps, lane);
    else if (M >= 2 && mp == 2)
      fft_pass<(M >= 2 ? 2 : 1)>(x, k0, nfft, log2n, pc, ps, lane);
    else
      fft_pass<1>(x, k0, nfft, log2n, pc, ps, lane);
    __syncwarp();
  }
}

// The pass size M for nfft: chunks of min(nfft / 32, 16) elements, at
// least 4.
inline int fft_m(int nfft) { return nfft >= 512 ? 3 : nfft == 256 ? 2 : 1; }

// dst[i] = src[i] for i = tid, tid + nthr, ... < n, four loads in flight
// a thread
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int n, int tid, int nthr) {
  for (int i = tid; i < n; i += 4 * nthr) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nthr < n) v[u] = src[i + u * nthr];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nthr < n) dst[i + u * nthr] = v[u];
  }
}

// Shared memory of a block of W frames: the W FFT buffers, the sample
// span, window, twiddles by stage (float64), mel coefficients, filter
// starts and widths (32-bit).
size_t spec_smem(int W, int shift, int size, int nfft, int nfilt, int maxw) {
  const size_t doubles = (size_t)W * nfft + (size_t)(W - 1) * shift + size +
                         size + (size_t)nfft;
  return doubles * sizeof(double) +
         ((size_t)nfilt * maxw + 2 * (size_t)nfilt) * 4;
}

// W for nfft on the current device: buffers of about kFftBytes, halved
// while the block would not fit the device's shared memory; 0 where one
// frame does not fit, -1 where the device cannot be read.  A small batch,
// such as a stream's piece, keeps W too: with fewer frames a block its
// blocks stage the tables with fewer threads, which read slower on the
// card than the SMs they free gain.
int spec_frames(int nfft, int shift, int size, int nfilt, int maxw,
                size_t* smem) {
  int optin = 0;
  if (sst_device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin) !=
      cudaSuccess)
    return -1;
  int W = kFftBytes / (nfft * (int)sizeof(double));
  W = W < 1 ? 1 : W > kMaxFrames ? kMaxFrames : W;
  while (W > 1 && spec_smem(W, shift, size, nfft, nfilt, maxw) > (size_t)optin)
    W /= 2;
  *smem = spec_smem(W, shift, size, nfft, nfilt, maxw);
  return *smem > (size_t)optin ? 0 : W;
}

template <typename In, int M>
__global__ void __launch_bounds__(32 * kMaxFrames)
fe_spec_kernel(const In* __restrict__ sig, const int32_t* __restrict__ n_samps,
               const float* __restrict__ prior,
               const double* __restrict__ window,
               const double* __restrict__ ccc, const double* __restrict__ sss,
               const int32_t* __restrict__ spec_start,
               const int32_t* __restrict__ widths,
               const float* __restrict__ coeff, double* __restrict__ out,
               int N, int T, int W, int shift, int size, int nfft, int log2n,
               int nfilt, int maxw, double alpha, int remove_dc) {
  extern __shared__ double sm[];
  const int nspan = (W - 1) * shift + size;
  double* xs = sm;                           // [W, nfft] FFT buffers
  double* span = xs + (size_t)W * nfft;      // [nspan] pre-emphasised
  double* win = span + nspan;                // [size]
  double* pc = win + size;                   // [nfft/2] cos by stage
  double* ps = pc + nfft / 2;                // [nfft/2] sin by stage
  float* cf = (float*)(ps + nfft / 2);       // [nfilt, maxw]
  int* st = (int*)(cf + nfilt * maxw);       // [nfilt]
  int* wd = st + nfilt;                      // [nfilt]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * W;
  const int nw = min(W, T - t0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const In* s = sig + (size_t)b * N;
  const long long ns = min(n_samps[b], N);

  stage(win, window, size, tid, nthr);
  stage(cf, coeff, nfilt * maxw, tid, nthr);
  stage(st, spec_start, nfilt, tid, nthr);
  stage(wd, widths, nfilt, tid, nthr);
  // stage k's twiddle of item j (ccc[j << (log2n - k - 1)]) at
  // (1 << (k-1)) + j
  for (int i0 = tid + 1; i0 < nfft / 2; i0 += 2 * nthr) {
    double c[2], sn[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * nthr;
      if (i < nfft / 2) {
        const int k = 32 - __clz(i);
        const int src = (i - (1 << (k - 1))) << (log2n - k - 1);
        c[u] = ccc[src];
        sn[u] = sss[src];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i0 + u * nthr < nfft / 2) {
        pc[i0 + u * nthr] = c[u];
        ps[i0 + u * nthr] = sn[u];
      }
    }
  }
  // pre-emphasis of the block's span (prior before sample 0; samples >=
  // n_samps are zero), once a sample
  const long long base = (long long)t0 * shift;
  const int nused = (nw - 1) * shift + size;
  for (int l0 = tid; l0 < nused; l0 += 2 * nthr) {
    double cur[2], prev[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long i = base + l0 + u * nthr;
      cur[u] = prev[u] = 0.0;
      if (l0 + u * nthr < nused && i < ns) {
        cur[u] = (double)(float)s[i];
        prev[u] = i == 0 ? (double)prior[b] : (double)(float)s[i - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int l = l0 + u * nthr;
      if (l < nused)
        span[l] = base + l < ns ? __fma_rn(-prev[u], alpha, cur[u]) : 0.0;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp < nw) {
    double* x = xs + (size_t)warp * nfft;
    const double* fr = span + warp * shift;  // the frame's size samples
    double sum = 0.0, inv = 0.0;
    if (remove_dc) {
      sum = warp_frame_sum(fr, size, x, x + nfft / 2, lane);
      inv = __drcp_rn((double)size);
    }
    warp_fft<M>(x, fr, win, size, remove_dc, sum, inv, nfft, log2n, pc, ps,
                lane);
    // power spectrum (fe_spec_magnitude) in place: bin j reads x[j] and
    // x[nfft - j], which no other bin writes
    for (int j = lane; j <= nfft / 2; j += 32) {
      const double a = x[swz(j)];
      x[swz(j)] = j == 0 ? __dmul_rn(a, a)
                         : __fma_rn(a, a, __dmul_rn(x[swz(nfft - j)],
                                                    x[swz(nfft - j)]));
    }
  }
  __syncthreads();
  // mel fold: a chain per frame and filter over the block, each in
  // coefficient order (fe_mel_spec)
  double* o = out + ((size_t)b * T + t0) * nfilt;
  for (int c = tid; c < nw * nfilt; c += nthr) {
    const int w = c / nfilt;
    const int i = c - w * nfilt;
    const double* spec = xs + (size_t)w * nfft;
    const int s0 = st[i];
    const float* cfi = cf + i * maxw;
    double acc = 0.0;
    for (int k = 0; k < wd[i]; ++k)
      acc = __fma_rn(spec[swz(min(s0 + k, nfft / 2))], (double)cfi[k], acc);
    o[c] = acc;
  }
}

template <typename In, int M>
int launch(const In* sig, const int32_t* n_samps, const float* prior,
           const double* window, const double* ccc, const double* sss,
           const int32_t* spec_start, const int32_t* widths,
           const float* coeff, double* out, int B, int N, int T, int W,
           size_t smem, int shift, int size, int nfft, int log2n, int nfilt,
           int maxw, double alpha, int remove_dc, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fe_spec_kernel<In, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + W - 1) / W, B);
  fe_spec_kernel<In, M><<<grid, 32 * W, smem, stream>>>(
      sig, n_samps, prior, window, ccc, sss, spec_start, widths, coeff, out,
      N, T, W, shift, size, nfft, log2n, nfilt, maxw, alpha, remove_dc);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_m(const In* sig, const int32_t* n_samps, const float* prior,
             const double* window, const double* ccc, const double* sss,
             const int32_t* spec_start, const int32_t* widths,
             const float* coeff, double* out, int B, int N, int T, int W,
             size_t smem, int shift, int size, int nfft, int log2n,
             int nfilt, int maxw, double alpha, int remove_dc,
             cudaStream_t stream) {
  const auto go = fft_m(nfft) == 3   ? launch<In, 3>
                  : fft_m(nfft) == 2 ? launch<In, 2>
                                     : launch<In, 1>;
  return go(sig, n_samps, prior, window, ccc, sss, spec_start, widths, coeff,
            out, B, N, T, W, smem, shift, size, nfft, log2n, nfilt, maxw,
            alpha, remove_dc, stream);
}

}  // namespace

extern "C" int sst_fe_spec_frames(int shift, int size, int nfft, int nfilt,
                                  int maxw) {
  size_t smem = 0;
  return spec_frames(nfft, shift, size, nfilt, maxw, &smem);
}

extern "C" int sst_fe_spec(const void* sig, int sig_i16, const int32_t* n_samps,
                           const float* prior, const double* window,
                           const int32_t* perm, const double* ccc,
                           const double* sss, const int32_t* spec_start,
                           const int32_t* widths, const float* coeff,
                           double* out, int B, int N, int T, int shift,
                           int size, int nfft, int nfilt, int maxw,
                           double alpha, int remove_dc, cudaStream_t stream) {
  if (nfft < 4 || (nfft & (nfft - 1)) || size > nfft || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  int log2n = 0;
  while ((1 << log2n) < nfft) ++log2n;
  size_t smem = 0;
  const int W = spec_frames(nfft, shift, size, nfilt, maxw, &smem);
  if (W < 0) return (int)cudaErrorUnknown;
  if (W == 0) return (int)cudaErrorInvalidValue;
  if (sig_i16)
    return launch_m((const int16_t*)sig, n_samps, prior, window, ccc, sss,
                    spec_start, widths, coeff, out, B, N, T, W, smem, shift,
                    size, nfft, log2n, nfilt, maxw, alpha, remove_dc, stream);
  return launch_m((const float*)sig, n_samps, prior, window, ccc, sss,
                  spec_start, widths, coeff, out, B, N, T, W, smem, shift,
                  size, nfft, log2n, nfilt, maxw, alpha, remove_dc, stream);
}
