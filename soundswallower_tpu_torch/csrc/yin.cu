// K14 `yin_cmnd`: YIN's float32 CMND and period pick, one block per frame.
//
// Replaces the TPU program B11 (soundswallower_tpu/yin.py:255 cmnd_batch,
// :280 pitch_batch): the JAX program gathered the [ndiff, ndiff] lag
// matrix x[t+j] per frame, squared (x[j] - x[t+j]) into device memory,
// reduced it over j, took a cumulative sum and the pick.  Here a block
// holds its frame's samples in shared memory and the lag matrix is never
// written anywhere: each thread computes d(t) for its lags from shared
// memory, the block scans d in shared memory and picks the period.
//
// The float32 order is the JAX program's as XLA's CPU backend compiles it
// (yin.py's docstring): the square rounded on its own, then the tree of
// windows of 32 (padding split, smaller half in front) with sequential
// sums from 0 inside each window and at the top; the blocked scan of 16
// (a running sum per block, the block totals scanned the same way, the
// total of the blocks before added to each lane); (d * t) / cum in IEEE
// division with cum <= 0 replaced by 1, d'(0) = 1, x 32768; the first lag
// under the threshold, else the first minimum (a NaN first).  Built with
// -fmad=false, and every operation is written with its _rn intrinsic.
//
// Bound: operations.  A frame costs ndiff^2 subtractions, multiplies and
// adds (3 ndiff^2 float32 operations) on 2 F + 4 ndiff + 12 bytes of
// input and output.  Threads of a warp take consecutive lags, so x[j] is
// a shared-memory broadcast and x[t+j] consecutive words.  Later work:
// more than one frame per block where ndiff is small, and the lag sums
// split over warps where the frame count cannot fill the card.
#include <climits>

#include "sst_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTreeWindow = 32;
constexpr int kScanBlock = 16;
constexpr int kMaxTree = 4;       // window levels: ndiff <= 32^5
constexpr int kMaxScan = 6;       // scan levels: ndiff <= 16^6

struct Tree {
  int levels;                     // window levels above the squares
  int n[kMaxTree + 1];            // values at each level
  int lo[kMaxTree];               // front padding of level l's windows
};

__device__ Tree make_tree(int ndiff) {
  Tree tr;
  tr.levels = 0;
  tr.n[0] = ndiff;
  while (tr.n[tr.levels] > kTreeWindow && tr.levels < kMaxTree) {
    const int n = tr.n[tr.levels];
    const int w = (n + kTreeWindow - 1) / kTreeWindow;
    tr.lo[tr.levels] = (w * kTreeWindow - n) / 2;
    tr.n[++tr.levels] = w;
  }
  return tr;
}

struct Lag {
  const float* x;                 // the frame in shared memory
  int t;                          // the lag
  int last;                       // frame_size - 1: later samples clamp
};

// value i of window level L: the square (L = 0) or a window's sum
template <int L>
__device__ float level_value(const Lag& g, const Tree& tr, int i);

template <>
__device__ __forceinline__ float level_value<0>(const Lag& g, const Tree& tr,
                                                int j) {
  const float df = __fsub_rn(g.x[j], g.x[min(g.t + j, g.last)]);
  return __fmul_rn(df, df);
}

template <int L>
__device__ float level_value(const Lag& g, const Tree& tr, int i) {
  const int a = i * kTreeWindow - tr.lo[L - 1];
  const int b = min(a + kTreeWindow, tr.n[L - 1]);
  float acc = 0.f;
  for (int k = max(a, 0); k < b; ++k)
    acc = __fadd_rn(acc, level_value<L - 1>(g, tr, k));
  return acc;
}

template <int L>
__device__ float lag_sum(const Lag& g, const Tree& tr) {
  float acc = 0.f;
  for (int i = 0; i < tr.n[L]; ++i)
    acc = __fadd_rn(acc, level_value<L>(g, tr, i));
  return acc;
}

__device__ float diff_energy(const Lag& g, const Tree& tr) {
  switch (tr.levels) {
    case 0: return lag_sum<0>(g, tr);
    case 1: return lag_sum<1>(g, tr);
    case 2: return lag_sum<2>(g, tr);
    case 3: return lag_sum<3>(g, tr);
    default: return lag_sum<4>(g, tr);
  }
}

// In-place inclusive scan of a[0, n) in XLA's blocked order; tot holds
// the block totals of every level (sum of ceil(n / 16^l), l >= 1).
__device__ void blocked_scan(float* a, float* tot, int n) {
  int m[kMaxScan + 1];
  float* arr[kMaxScan + 1];
  int K = 0;
  m[0] = n;
  arr[0] = a;
  float* next = tot;
  while (m[K] > kScanBlock && K < kMaxScan) {
    const int mb = (m[K] + kScanBlock - 1) / kScanBlock;
    arr[K + 1] = next;
    next += mb;
    m[K + 1] = mb;
    ++K;
  }
  // up: a running sum inside each block of 16, its total one level up
  for (int l = 0; l < K; ++l) {
    for (int b = threadIdx.x; b < m[l + 1]; b += blockDim.x) {
      float* p = arr[l] + b * kScanBlock;
      const int len = min(kScanBlock, m[l] - b * kScanBlock);
      float acc = 0.f;
      for (int k = 0; k < len; ++k) {
        acc = __fadd_rn(acc, p[k]);
        p[k] = acc;
      }
      arr[l + 1][b] = acc;
    }
    __syncthreads();
  }
  // top: at most 16 values, a running sum
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < m[K]; ++k) {
      acc = __fadd_rn(acc, arr[K][k]);
      arr[K][k] = acc;
    }
  }
  __syncthreads();
  // down: each lane of block b >= 1 adds the scan of the totals at b - 1
  for (int l = K - 1; l >= 0; --l) {
    for (int i = threadIdx.x + kScanBlock; i < m[l]; i += blockDim.x)
      arr[l][i] = __fadd_rn(arr[l][i], arr[l + 1][i / kScanBlock - 1]);
    __syncthreads();
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
yin_cmnd_kernel(const In* __restrict__ frames, float* __restrict__ cmnd,
                int64_t* __restrict__ period, float* __restrict__ best, int F,
                int ndiff, float thr) {
  extern __shared__ float smem[];
  float* x = smem;                 // [F]
  float* d = x + F;                // [ndiff]
  float* cum = d + ndiff;          // [ndiff]
  float* tot = cum + ndiff;        // block totals of the scan
  __shared__ int s_under[kThreads];
  __shared__ int s_nan[kThreads];
  __shared__ int s_min[kThreads];
  __shared__ float s_minv[kThreads];

  const int row = blockIdx.x;
  const In* fr = frames + (size_t)row * F;
  for (int i = threadIdx.x; i < F; i += blockDim.x) x[i] = (float)fr[i];
  __syncthreads();

  const Tree tr = make_tree(ndiff);
  for (int t = threadIdx.x; t < ndiff; t += blockDim.x) {
    const Lag g{x, t, F - 1};
    const float v = diff_energy(g, tr);
    d[t] = v;
    cum[t] = v;
  }
  __syncthreads();
  blocked_scan(cum, tot, ndiff);

  float* out = cmnd + (size_t)row * ndiff;
  int under = INT_MAX, nan = INT_MAX, imin = INT_MAX;
  float vmin = __int_as_float(0x7f800000);   // +inf
  for (int t = threadIdx.x; t < ndiff; t += blockDim.x) {
    const float c = cum[t] <= 0.f ? 1.f : cum[t];
    float v = __fdiv_rn(__fmul_rn(d[t], (float)t), c);
    if (t == 0) v = 1.f;
    v = __fmul_rn(v, 32768.f);
    out[t] = v;
    cum[t] = v;                    // kept for the pick's best value
    if (v < thr && t < under) under = t;
    if (v != v) {
      if (t < nan) nan = t;
    } else if (v < vmin || (v == vmin && t < imin)) {
      vmin = v;
      imin = t;
    }
  }
  s_under[threadIdx.x] = under;
  s_nan[threadIdx.x] = nan;
  s_min[threadIdx.x] = imin;
  s_minv[threadIdx.x] = vmin;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < blockDim.x; ++k) {
      under = min(under, s_under[k]);
      nan = min(nan, s_nan[k]);
      const float w = s_minv[k];
      if (s_min[k] != INT_MAX &&
          (w < vmin || (w == vmin && s_min[k] < imin))) {
        vmin = w;
        imin = s_min[k];
      }
    }
    const int p = under != INT_MAX ? under
                  : (nan != INT_MAX ? nan : (imin != INT_MAX ? imin : 0));
    period[row] = p;
    best[row] = cum[p];
  }
}

size_t scan_totals(int n) {
  size_t s = 0;
  for (int l = 0; l < kMaxScan && n > kScanBlock; ++l) {
    n = (n + kScanBlock - 1) / kScanBlock;
    s += n;
  }
  return s;
}

size_t smem_bytes(int F, int ndiff) {
  return sizeof(float) * ((size_t)F + 2 * (size_t)ndiff + scan_totals(ndiff));
}

}  // namespace

extern "C" int sst_yin_cmnd(const void* frames, int is_i16, float* cmnd,
                            int64_t* period, float* best, int N, int F,
                            int ndiff, float thr, cudaStream_t stream) {
  if (N <= 0 || ndiff <= 0) return (int)cudaSuccess;
  if (F <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, ndiff);
  cudaError_t e;
  if (is_i16) {
    e = cudaFuncSetAttribute(yin_cmnd_kernel<int16_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    yin_cmnd_kernel<int16_t><<<N, kThreads, smem, stream>>>(
        (const int16_t*)frames, cmnd, period, best, F, ndiff, thr);
  } else {
    e = cudaFuncSetAttribute(yin_cmnd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    yin_cmnd_kernel<float><<<N, kThreads, smem, stream>>>(
        (const float*)frames, cmnd, period, best, F, ndiff, thr);
  }
  return (int)cudaGetLastError();
}
