// K9 `fe_noise`: the noise-removal recurrence over frames, with its carry.
//
// Replaces the scan of the jitted XLA program B10 of the JAX package:
// soundswallower_tpu/fe/frontend.py Frontend._remove_noise_scan (step and
// step_masked, fe_remove_noise of fe_noise.c).
//
// Bound: the frame recurrence's latency.  The carry (power, noise, floor,
// peak per filter, undef per row) makes the frames sequential; the
// filters are independent except for the +-4 gain smoothing.  So one
// block owns one row and walks its frames, one thread per filter with the
// carry in registers; the gains go through shared memory, and each
// thread folds its window of neighbours sequentially in index order (two
// barriers per frame).  Rows run in parallel, a block each.  Frames at
// and after n_frames[b] still produce an output but leave the carry as it
// was, as step_masked does.
//
// The float64 arithmetic is the JAX program's as its CPU backend compiles
// it: XLA replaces x / 20 by x * 0.05 and x / width by x * (1 / width),
// multiplies out constant factors (peak * 0.85 * 0.85, peak * 0.85 * 0.2),
// rewrites 0.5 * a + 0.5 * b as (a + b) * 0.5, and contracts each
// remaining multiply-add into an FMA in the operand order its compiler
// chose; the floor update's order differs between the masked and the
// plain scan (`masked`), and on a row's first frame of the masked scan
// the floor carry takes a third form.  See fe/frontend.py
// fe_noise_plain.
#include "sst_kernels.h"

namespace {

constexpr double kLambdaPower = 0.7;
constexpr double kLambdaA = 0.995;
constexpr double kLambdaB = 0.5;
constexpr double kLambdaT = 0.85;
constexpr double kMuT = 0.2;
constexpr double kMaxGain = 20.0;
constexpr double kInvMaxGain = 1.0 / kMaxGain;
constexpr double kLtLt = kLambdaT * kLambdaT;
constexpr double kLtMu = kLambdaT * kMuT;
constexpr int kSmooth = 4;

// XLA's maximum: NaN if either operand is NaN
__device__ __forceinline__ double xmax(double a, double b) {
  if (a != a || b != b) return __dadd_rn(a, b);
  return a > b ? a : b;
}

// The noise and floor updates from the smoothed power p (_noise_floor
// in fe/frontend.py): each an FMA of one product into the other, the
// fused product chosen as the JAX program's compiler chose it.
__device__ __forceinline__ void noise_floor(double p, double n_in, double f_in,
                                            bool masked, bool shared,
                                            double* nz, double* sig,
                                            double* fl) {
  const double n_up =
      shared ? __fma_rn(p, 1.0 - kLambdaA, __dmul_rn(n_in, kLambdaA))
             : __fma_rn(n_in, kLambdaA, __dmul_rn(p, 1.0 - kLambdaA));
  *nz = p >= n_in ? n_up : __dmul_rn(__dadd_rn(n_in, p), kLambdaB);
  *sig = xmax(__dsub_rn(p, *nz), 1.0);
  const double f_up =
      masked ? __fma_rn(f_in, kLambdaA, __dmul_rn(*sig, 1.0 - kLambdaA))
             : __fma_rn(*sig, 1.0 - kLambdaA, __dmul_rn(f_in, kLambdaA));
  *fl = *sig >= f_in ? f_up : __dmul_rn(__dadd_rn(f_in, *sig), kLambdaB);
}

__global__ void fe_noise_kernel(const double* __restrict__ mfspec,
                                const int32_t* __restrict__ n_frames,
                                double* power, double* noise, double* floor_,
                                double* peak, uint8_t* undef,
                                double* __restrict__ out, int T, int nf,
                                int masked) {
  extern __shared__ double gain[];  // [nf]
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool lane = i < nf;
  const int n = n_frames[b];
  const size_t c = (size_t)b * nf + i;
  double P = 0.0, N = 0.0, F = 0.0, PK = 0.0;
  if (lane) {
    P = power[c];
    N = noise[c];
    F = floor_[c];
    PK = peak[c];
  }
  bool u = undef[b] != 0;
  const int lo = max(i - kSmooth, 0);
  const int hi = min(i + kSmooth, nf - 1);
  const double inv_w = __ddiv_rn(1.0, (double)(hi - lo + 1));

  for (int t = 0; t < T; ++t) {
    const size_t at = ((size_t)b * T + t) * nf + i;
    const double mfs = lane ? mfspec[at] : 0.0;
    const double p_in = u ? mfs : P;
    const double n_in = u ? __dmul_rn(mfs, kInvMaxGain) : N;
    const double f_in = u ? __dmul_rn(mfs, kInvMaxGain) : F;
    const double pk_in = u ? 0.0 : PK;
    const double p = __fma_rn(mfs, 1.0 - kLambdaPower,
                              __dmul_rn(p_in, kLambdaPower));
    double nz, sig, fl;
    noise_floor(p, n_in, f_in, masked, false, &nz, &sig, &fl);
    double fl_keep = fl;
    if (masked && u) {
      // the floor carry of a row's first frame (fe_noise_plain)
      double nz1, sig1;
      noise_floor(p, n_in, f_in, false, true, &nz1, &sig1, &fl_keep);
    }
    // temporal masking against the decayed peak
    const double sig_m =
        sig < __dmul_rn(pk_in, kLtLt) ? __dmul_rn(pk_in, kLtMu) : sig;
    const double pk_dec = __dmul_rn(pk_in, kLambdaT);
    const double pk = sig > pk_dec ? sig : pk_dec;
    const double s2 = xmax(sig_m, fl);
    const double g = s2 < __dmul_rn(p, kMaxGain)
                         ? xmax(__ddiv_rn(s2, p), kInvMaxGain)
                         : kMaxGain;
    if (lane) gain[i] = g;
    __syncthreads();
    if (lane) {
      double coef = 0.0;
      for (int j = lo; j <= hi; ++j) coef = __dadd_rn(coef, gain[j]);
      out[at] = __dmul_rn(mfs, __dmul_rn(coef, inv_w));
    }
    __syncthreads();
    if (t < n) {
      P = p;
      N = nz;
      F = fl_keep;
      PK = pk;
      u = false;
    }
  }
  if (lane) {
    power[c] = P;
    noise[c] = N;
    floor_[c] = F;
    peak[c] = PK;
  }
  if (i == 0) undef[b] = u ? 1 : 0;
}

}  // namespace

extern "C" int sst_fe_noise(const double* mfspec, const int32_t* n_frames,
                            double* power, double* noise, double* floor_,
                            double* peak, uint8_t* undef, double* out, int B,
                            int T, int nf, int masked, cudaStream_t stream) {
  if (nf <= 0 || nf > 1024) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const int threads = (nf + 31) / 32 * 32;
  fe_noise_kernel<<<B, threads, nf * sizeof(double), stream>>>(
      mfspec, n_frames, power, noise, floor_, peak, undef, out, T, nf, masked);
  return (int)cudaGetLastError();
}
