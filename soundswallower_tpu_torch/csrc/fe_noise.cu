// K9 `fe_noise`: the noise-removal recurrence over frames, with its carry.
//
// Replaces the scan of the jitted XLA program B10 of the JAX package:
// soundswallower_tpu/fe/frontend.py Frontend._remove_noise_scan (step and
// step_masked, fe_remove_noise of fe_noise.c).
//
// Bound: the frame recurrence's latency.  The carry (power, noise, floor,
// peak per filter, undef per row) makes the frames sequential, but it
// never reads the gain: the gain's division and the +-4 smoothing of the
// gains across filters lie on the output's path alone.  So one block owns
// one row and works in tiles of F frames (sst_fe_noise_tile), in two
// phases that run at once on consecutive tiles, one block barrier a tile:
//
// * phase A, the producer warps (a thread a filter): each walks its
//   filter's recurrence over the tile with the carry in registers and
//   writes each frame's masked signal s2 and smoothed power p to shared
//   [F, nf] tiles; no barrier and no division a frame; after the row's
//   first kept frame, the frame's work in three stages, software-
//   pipelined over three frames, so that a frame's work overlaps the
//   next ones';
// * phase B, the consumer warps, on the tile before: the gains from s2
//   and p in place, then the smoothed output out[t, i] = mfs * (sum_{j =
//   lo..hi} g[t, j] * inv_w), the sum in index order from lo, a thread an
//   entry, stores coalesced; and the next tile's mel spectra, loaded into
//   a ring of three shared tiles.
//
// Past 31 producer warps (nf > 992) there is no room for consumers: the
// producers then finish their own tile after a second barrier.  Frames
// at and after n_frames[b] still produce an output but leave the carry as
// it was, as step_masked does.
//
// The float64 arithmetic is the JAX program's as its CPU backend compiles
// it: XLA replaces x / 20 by x * 0.05 and x / width by x * (1 / width),
// multiplies out constant factors (peak * 0.85 * 0.85, peak * 0.85 * 0.2),
// rewrites 0.5 * a + 0.5 * b as (a + b) * 0.5, and contracts each
// remaining multiply-add into an FMA in the operand order its compiler
// chose; the floor update's order differs between the masked and the
// plain scan (`masked`), and on a row's first frame of the masked scan
// the floor carry takes a third form.  See fe/frontend.py
// fe_noise_plain, which runs the same two phases.
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
constexpr int kTile = 32;       // frames a tile, where shared memory holds it
constexpr int kMaxThreads = 1024;

// XLA's maximum: NaN if either operand is NaN (selects, no branch)
__device__ __forceinline__ double xmax(double a, double b) {
  const double m = a > b ? a : b;
  return a == a && b == b ? m : __dadd_rn(a, b);
}

// The noise and floor updates (_noise_floor in fe/frontend.py): each an
// FMA of one product into the other, the fused product chosen as the JAX
// program's compiler chose it (`shared`: on a row's first frame, where
// the noise and floor inputs are one value; `masked`: the masked scan's
// floor).
__device__ __forceinline__ double noise_up(double p, double n_in,
                                           bool shared) {
  const double up =
      shared ? __fma_rn(p, 1.0 - kLambdaA, __dmul_rn(n_in, kLambdaA))
             : __fma_rn(n_in, kLambdaA, __dmul_rn(p, 1.0 - kLambdaA));
  return p >= n_in ? up : __dmul_rn(__dadd_rn(n_in, p), kLambdaB);
}

__device__ __forceinline__ double floor_up(double sig, double f_in,
                                           bool masked) {
  const double up =
      masked ? __fma_rn(f_in, kLambdaA, __dmul_rn(sig, 1.0 - kLambdaA))
             : __fma_rn(sig, 1.0 - kLambdaA, __dmul_rn(f_in, kLambdaA));
  return sig >= f_in ? up : __dmul_rn(__dadd_rn(f_in, sig), kLambdaB);
}

// A frame's recurrence in three stages: (1) the smoothed power p and the
// noise nz from the previous power and noise; (2) the signal; (3) the
// floor fl, the peak pk and the masked signal s2 (the gain's numerator)
// from the previous floor and peak.
__device__ __forceinline__ void stage1(double mfs, double p_in, double n_in,
                                       double* p, double* nz) {
  *p = __fma_rn(mfs, 1.0 - kLambdaPower, __dmul_rn(p_in, kLambdaPower));
  *nz = noise_up(*p, n_in, false);
}

__device__ __forceinline__ double stage2(double p, double nz) {
  return xmax(__dsub_rn(p, nz), 1.0);
}

template <bool MASKED>
__device__ __forceinline__ void stage3(double sig, double f_in, double pk_in,
                                       double* s2, double* fl, double* pk) {
  *fl = floor_up(sig, f_in, MASKED);
  // temporal masking against the decayed peak
  const double sig_m =
      sig < __dmul_rn(pk_in, kLtLt) ? __dmul_rn(pk_in, kLtMu) : sig;
  const double pk_dec = __dmul_rn(pk_in, kLambdaT);
  *pk = sig > pk_dec ? sig : pk_dec;
  *s2 = xmax(sig_m, *fl);
}

// threads of the producer warps: a thread a filter
__host__ __device__ inline int producer_threads(int nf) {
  return (nf + 31) / 32 * 32;
}

// threads of the block: the producers and eight consumer warps, or as
// many as fit
inline int block_threads(int nf) {
  const int prod = producer_threads(nf);
  const int cons = prod + 256 <= kMaxThreads ? 8 : (kMaxThreads - prod) / 32;
  return prod + 32 * cons;
}

inline size_t noise_smem(int nf, int F) {
  // three mel-spectrum tiles, two of s2 (then the gains), two of p, and
  // 1 / width per filter
  return ((size_t)7 * F + 1) * nf * sizeof(double);
}

// dst[e] = src[e] for e = i0, i0 + stride, ... < cnt, four loads in
// flight a thread
__device__ __forceinline__ void copy(double* dst,
                                     const double* __restrict__ src, int cnt,
                                     int i0, int stride) {
  for (int e = i0; e < cnt; e += 4 * stride) {
    double v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * stride < cnt) v[u] = src[e + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * stride < cnt) dst[e + u * stride] = v[u];
  }
}

// the consumer warps' barrier (named barrier 1), or the block's where
// every thread consumes
__device__ __forceinline__ void consumers_sync(bool split, int ncons) {
  if (split)
    asm volatile("bar.sync 1, %0;" ::"r"(ncons) : "memory");
  else
    __syncthreads();
}

// MAXT: the block's most threads (its launch bound: 512 leaves the
// pipelined phase A its registers)
template <bool MASKED, int MAXT>
__global__ void __launch_bounds__(MAXT)
fe_noise_kernel(const double* __restrict__ mfspec,
                const int32_t* __restrict__ n_frames, double* power,
                double* noise, double* floor_, double* peak, uint8_t* undef,
                double* __restrict__ out, int T, int nf, int F) {
  extern __shared__ double sm[];
  const int tsz = F * nf;
  double* mbuf = sm;               // [3][F, nf] mel spectra, a ring
  double* sbuf = sm + 3 * tsz;     // [2][F, nf] s2, then the gains
  double* pbuf = sbuf + 2 * tsz;   // [2][F, nf] smoothed power
  double* inv_w = pbuf + 2 * tsz;  // [nf] 1 / the smoothing width
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nprod = producer_threads(nf);
  // consumers: the warps after the producers', or every thread where
  // the block has no others
  const bool split = nthr > nprod;
  const int c0 = split ? nprod : 0;
  const int ncons = nthr - c0;
  const int ntiles = (T + F - 1) / F;
  const double* src = mfspec + (size_t)b * T * nf;
  double* dst = out + (size_t)b * T * nf;

  for (int i = tid; i < nf; i += nthr) {
    const int lo = max(i - kSmooth, 0), hi = min(i + kSmooth, nf - 1);
    inv_w[i] = __ddiv_rn(1.0, (double)(hi - lo + 1));
  }
  copy(mbuf, src, min(F, T) * nf, tid, nthr);

  const bool prod = tid < nf;
  const int n = n_frames != nullptr ? n_frames[b] : T;
  const size_t c = (size_t)b * nf + tid;
  double P = 0.0, N = 0.0, FL = 0.0, PK = 0.0;
  if (prod) {
    P = power[c];
    N = noise[c];
    FL = floor_[c];
    PK = peak[c];
  }
  bool u = undef[b] != 0;
  __syncthreads();

  for (int k = 0; k <= ntiles; ++k) {
    // phase A on tile k
    if (prod && k < ntiles) {
      const int t0 = k * F;
      const int fk = min(F, T - t0);
      const double* m = mbuf + (k % 3) * tsz + tid;
      double* s2t = sbuf + (k & 1) * tsz + tid;
      double* pt = pbuf + (k & 1) * tsz + tid;
      int tt = 0;
      // frames while the row is undefined: the carry taken from the
      // frame itself, and on the masked scan's first frame the floor
      // carry's own form (fe_noise_plain)
      for (; tt < fk && u; ++tt) {
        const double mfs = m[tt * nf];
        const double n_in = __dmul_rn(mfs, kInvMaxGain);
        double p, nz, s2, fl, pk;
        stage1(mfs, mfs, n_in, &p, &nz);
        stage3<MASKED>(stage2(p, nz), n_in, 0.0, &s2, &fl, &pk);
        if (MASKED)
          fl = floor_up(stage2(p, noise_up(p, n_in, true)), n_in, false);
        s2t[tt * nf] = s2;
        pt[tt * nf] = p;
        if (t0 + tt < n) {
          P = p;
          N = nz;
          FL = fl;
          PK = pk;
          u = false;
        }
      }
      // the rest software-pipelined: step q runs stage 1 of frame q,
      // stage 2 of frame q-1 and stage 3 of frame q-2, which are
      // independent; a stage of a frame outside [tt, fk) keeps the carry
      // and stores nothing
      double p2 = 0.0, nz2 = 0.0, p3 = 0.0, sig3 = 0.0;
      bool keep2 = false, keep3 = false;
#pragma unroll 2
      for (int q = tt; q < fk + 2; ++q) {
        double s2, fl, pk;
        stage3<MASKED>(sig3, FL, PK, &s2, &fl, &pk);
        FL = keep3 ? fl : FL;
        PK = keep3 ? pk : PK;
        if (q - 2 >= tt) {
          s2t[(q - 2) * nf] = s2;
          pt[(q - 2) * nf] = p3;
        }
        sig3 = stage2(p2, nz2);
        p3 = p2;
        keep3 = keep2;
        double p, nz;
        stage1(m[min(q, fk - 1) * nf], P, N, &p, &nz);
        keep2 = q < fk && t0 + q < n;
        P = keep2 ? p : P;
        N = keep2 ? nz : N;
        p2 = p;
        nz2 = nz;
      }
    }
    if (!split) __syncthreads();  // tile k's s2 and p, to every thread
    if (tid >= c0) {
      const int ct = tid - c0;
      // the next tile's mel spectra, into the ring slot read two tiles ago
      if (k + 1 < ntiles) {
        const int t1 = (k + 1) * F;
        copy(mbuf + ((k + 1) % 3) * tsz, src + (size_t)t1 * nf,
             min(F, T - t1) * nf, ct, ncons);
      }
      // phase B on the tile whose s2 and p are complete
      const int kb = split ? k - 1 : k;
      if (kb >= 0 && kb < ntiles) {
        const int t0 = kb * F;
        const int cnt = min(F, T - t0) * nf;
        const double* m = mbuf + (kb % 3) * tsz;
        double* g = sbuf + (kb & 1) * tsz;
        const double* pt = pbuf + (kb & 1) * tsz;
        // four entries at a time, their chains independent
        for (int e0 = ct; e0 < cnt; e0 += 4 * ncons) {
          double s2[4], p[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int e = e0 + v * ncons;
            s2[v] = e < cnt ? g[e] : 1.0;
            p[v] = e < cnt ? pt[e] : 1.0;
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int e = e0 + v * ncons;
            const double gv = s2[v] < __dmul_rn(p[v], kMaxGain)
                                  ? xmax(__ddiv_rn(s2[v], p[v]), kInvMaxGain)
                                  : kMaxGain;
            if (e < cnt) g[e] = gv;
          }
        }
        consumers_sync(split, ncons);
        double* o = dst + (size_t)t0 * nf;
        for (int e0 = ct; e0 < cnt; e0 += 4 * ncons) {
          int lo[4], hi[4];
          double coef[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int e = e0 + v * ncons < cnt ? e0 + v * ncons : cnt - 1;
            const int i = e % nf;
            lo[v] = e - i + max(i - kSmooth, 0);
            hi[v] = e - i + min(i + kSmooth, nf - 1);
            coef[v] = 0.0;
          }
#pragma unroll
          for (int j = 0; j <= 2 * kSmooth; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (lo[v] + j <= hi[v]) coef[v] = __dadd_rn(coef[v], g[lo[v] + j]);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int e = e0 + v * ncons;
            if (e < cnt)
              o[e] = __dmul_rn(m[e], __dmul_rn(coef[v], inv_w[e % nf]));
          }
        }
      }
    }
    __syncthreads();
  }
  if (prod) {
    power[c] = P;
    noise[c] = N;
    floor_[c] = FL;
    peak[c] = PK;
  }
  if (tid == 0) undef[b] = u ? 1 : 0;
}

// The frame tile for nf filters on the current device (kTile, halved
// until the block's shared memory fits), -1 where none fits or the device
// cannot be read.
int noise_tile(int nf, size_t* smem) {
  int optin = 0;
  if (sst_device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin) !=
      cudaSuccess)
    return -1;
  for (int F = kTile; F >= 1; F /= 2) {
    if (noise_smem(nf, F) <= (size_t)optin) {
      *smem = noise_smem(nf, F);
      return F;
    }
  }
  return -1;
}

}  // namespace

extern "C" int sst_fe_noise_tile(int nf) {
  if (nf <= 0 || nf > kMaxThreads) return -1;
  size_t smem = 0;
  return noise_tile(nf, &smem);
}

extern "C" int sst_fe_noise(const double* mfspec, const int32_t* n_frames,
                            double* power, double* noise, double* floor_,
                            double* peak, uint8_t* undef, double* out, int B,
                            int T, int nf, int masked, cudaStream_t stream) {
  if (nf <= 0 || nf > kMaxThreads || T < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  size_t smem = 0;
  const int F = noise_tile(nf, &smem);
  if (F < 0) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(nf);
  const auto kernel =
      threads <= 512 ? (masked ? fe_noise_kernel<true, 512>
                               : fe_noise_kernel<false, 512>)
                     : (masked ? fe_noise_kernel<true, kMaxThreads>
                               : fe_noise_kernel<false, kMaxThreads>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, stream>>>(
      mfspec, n_frames, power, noise, floor_, peak, undef, out, T, nf, F);
  return (int)cudaGetLastError();
}
