// K14 `yin_cmnd`: YIN's float32 CMND and period pick.
//
// Replaces the TPU program B11 (soundswallower_tpu/yin.py:255 cmnd_batch,
// :280 pitch_batch): the JAX program gathered the [ndiff, ndiff] lag
// matrix x[t+j] per frame, squared (x[j] - x[t+j]) into device memory,
// reduced it over j, took a cumulative sum and the pick.  Here the lag
// matrix is never written anywhere.
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
// adds (3 ndiff^2 float32 operations; without FMA these are 3
// instructions, so the card's floor is at half its FMA rate) on
// 2 F + 4 ndiff + 12 bytes of input and output.
//
// yin_diff_kernel: a block of `tpf` threads takes tpf * R lags of one
// frame (a lag tile), R adjacent lags a thread in lockstep: x[j] is read
// once for the R lags and the x[t + j] of a window of 32 come from 16-byte
// loads of the block's staged frame, so a square costs its 3 operations
// and about 17/(32R) shared loads.  The staged frame carries sample F - 1
// past the frame (the JAX gather's clamp), so no window tests it.  Where
// a frame's lags fit one block (ndiff up to 512 at R = 4, 1,024 at R =
// 8), the block then scans, writes the CMND and picks: one launch.  A
// frame of more lags is cut into tiles of 64 threads, a block each, which
// write d(t) to cmnd; yin_finish_kernel, a block a frame and the first
// launch's programmatic dependent, then scans and picks.  The pick
// reduces with warp shuffles.
#include <climits>
#include <cstdint>

#include "sst_kernels.h"

namespace {

constexpr int kTreeWindow = 32;
constexpr int kScanBlock = 16;
constexpr int kMaxTree = 4;       // window levels: ndiff <= 32^5
constexpr int kMaxScan = 6;       // scan levels: ndiff <= 16^6
constexpr int kDiffThreads = 128; // threads of a diff block, at most
constexpr int kFinishThreads = 256;
constexpr int kStageExtra = 12;   // staged samples past 2 * ndiff
constexpr int kLoadUnroll = 8;    // global loads in flight a thread

struct Tree {
  int levels;                     // window levels above the squares
  int n[kMaxTree + 1];            // values at each level
  int lo[kMaxTree + 1];           // front padding of level l's windows
};

// Every index fixed at compile time, so the tree stays in registers.
__device__ __forceinline__ Tree make_tree(int ndiff) {
  Tree tr;
  tr.levels = 0;
  tr.n[0] = ndiff;
  tr.lo[kMaxTree] = 0;
#pragma unroll
  for (int l = 0; l < kMaxTree; ++l) {
    const int n = tr.n[l];
    const bool up = n > kTreeWindow;       // once false, false above too
    const int w = (n + kTreeWindow - 1) / kTreeWindow;
    tr.lo[l] = up ? (w * kTreeWindow - n) / 2 : 0;
    tr.n[l + 1] = up ? w : n;
    tr.levels += up;
  }
  return tr;
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The squares of a whole window of 32 for R lags, summed from 0 in j
// order: xa = &x[a], xb = &x[a + t0], both 16-byte aligned.
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The squares of a whole window of 32 for R lags, summed from 0 in j
// order: xa = &x[a], xb = &x[a + t0], both 16-byte aligned.  The loads
// stay float4 registers, every index fixed once unrolled.
template <int R>
__device__ __forceinline__ void window_full(const float* xa, const float* xb,
                                            float* w) {
  constexpr int NB = (kTreeWindow + R - 1 + 3) / 4;
  float4 av[kTreeWindow / 4];
  float4 bv[NB];
#pragma unroll
  for (int q = 0; q < kTreeWindow / 4; ++q)
    av[q] = reinterpret_cast<const float4*>(xa)[q];
#pragma unroll
  for (int q = 0; q < NB; ++q) bv[q] = reinterpret_cast<const float4*>(xb)[q];
#pragma unroll
  for (int k = 0; k < R; ++k) w[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kTreeWindow; ++j) {
    const float a = lane(av[j / 4], j % 4);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float df = __fsub_rn(a, lane(bv[(j + k) / 4], (j + k) % 4));
      w[k] = __fadd_rn(w[k], __fmul_rn(df, df));
    }
  }
}

// A window cut by the padding: j in [ja, jb), x = the staged frame.
template <int R>
__device__ __forceinline__ void window_part(const float* x, int ja, int jb,
                                            int t0, float* w) {
#pragma unroll
  for (int k = 0; k < R; ++k) w[k] = 0.f;
  for (int j = ja; j < jb; ++j) {
    const float a = x[j];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float df = __fsub_rn(a, x[t0 + k + j]);
      w[k] = __fadd_rn(w[k], __fmul_rn(df, df));
    }
  }
}

// d(t) of the R lags t0 .. t0 + R - 1 of the staged frame x: XLA's
// tree, whole windows of 32 from 16-byte loads, the windows cut by the
// padding one sample at a time; acc[l - 1] holds the open window of
// level l below the top, top the top's running sum, w the value just
// completed below.  Every index is fixed once the level loop unrolls,
// so acc stays in registers.
template <int R>
__device__ __forceinline__ void lag_sums(const float* x, const Tree& tr,
                                         int ndiff, int t0, float* val) {
  float acc[kMaxTree][R], top[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    top[k] = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxTree; ++l) acc[l][k] = 0.f;
  }
  float w[R];
  const int nw = tr.levels ? tr.n[1] : 1;
  for (int W = 0; W < nw; ++W) {
    const int a = W * kTreeWindow - tr.lo[0];
    const int ja = max(a, 0);
    const int jb = min(a + kTreeWindow, ndiff);
    if (ja == a && jb == a + kTreeWindow)
      window_full<R>(x + a, x + a + t0, w);
    else
      window_part<R>(x, ja, jb, t0, w);
    int i = W;                     // w's index at level l
    bool up = true;                // w still goes up to level l
#pragma unroll
    for (int l = 1; l <= kMaxTree; ++l) {
      if (!up || l > tr.levels) continue;
      if (l == tr.levels) {
#pragma unroll
        for (int k = 0; k < R; ++k) top[k] = __fadd_rn(top[k], w[k]);
        up = false;
        continue;
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[l - 1][k] = __fadd_rn(acc[l - 1][k], w[k]);
      const int p = i + tr.lo[l];
      if ((p & (kTreeWindow - 1)) == kTreeWindow - 1 || i == tr.n[l] - 1) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          w[k] = acc[l - 1][k];
          acc[l - 1][k] = 0.f;
        }
        i = p / kTreeWindow;
      } else {
        up = false;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) val[k] = tr.levels ? top[k] : w[k];
}

// In-place inclusive scan of a[0, n) in XLA's blocked order; tot holds
// the block totals of every level (sum of ceil(n / 16^l), l >= 1).  The
// level loops unroll with every index fixed, so m and arr stay in
// registers.
__device__ __forceinline__ void blocked_scan(float* a, float* tot, int n) {
  int m[kMaxScan + 1];
  float* arr[kMaxScan + 1];
  int K = 0;                        // levels below the top
  m[0] = n;
  arr[0] = a;
  float* next = tot;
#pragma unroll
  for (int l = 0; l < kMaxScan; ++l) {
    const bool up = m[l] > kScanBlock;      // once false, false above too
    const int mb = (m[l] + kScanBlock - 1) / kScanBlock;
    arr[l + 1] = next;
    m[l + 1] = up ? mb : m[l];
    next += up ? mb : 0;
    K += up;
  }
  // up: a running sum inside each block of 16, its total one level up
#pragma unroll
  for (int l = 0; l < kMaxScan; ++l) {
    if (l >= K) continue;
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
  float* top = a;
  int mt = n;
#pragma unroll
  for (int l = 1; l <= kMaxScan; ++l) {
    if (l == K) {
      top = arr[l];
      mt = m[l];
    }
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < mt; ++k) {
      acc = __fadd_rn(acc, top[k]);
      top[k] = acc;
    }
  }
  __syncthreads();
  // down: each lane of block b >= 1 adds the scan of the totals at b - 1
#pragma unroll
  for (int l = kMaxScan - 1; l >= 0; --l) {
    if (l >= K) continue;
    for (int i = threadIdx.x + kScanBlock; i < m[l]; i += blockDim.x)
      arr[l][i] = __fadd_rn(arr[l][i], arr[l + 1][i / kScanBlock - 1]);
    __syncthreads();
  }
}

struct Pick {
  int under, nan, imin;
  float vmin;
};

// b into a: the first lag under the threshold, the first NaN, the first
// minimum of the values that are not NaN
__device__ __forceinline__ void merge(Pick& a, const Pick& b) {
  a.under = min(a.under, b.under);
  a.nan = min(a.nan, b.nan);
  if (b.imin != INT_MAX &&
      (b.vmin < a.vmin || (b.vmin == a.vmin && b.imin < a.imin))) {
    a.vmin = b.vmin;
    a.imin = b.imin;
  }
}

// The CMND and the pick of one frame, by the whole block: dv and cum
// hold d(t), tot the scan's totals; writes out [ndiff], *period, *best.
__device__ void finish_frame(float* dv, float* cum, float* tot, int ndiff,
                             float thr, float* out, int64_t* period,
                             float* best, Pick* s_pick) {
  blocked_scan(cum, tot, ndiff);
  Pick pk{INT_MAX, INT_MAX, INT_MAX, __int_as_float(0x7f800000)};   // +inf
  for (int t = threadIdx.x; t < ndiff; t += blockDim.x) {
    const float c = cum[t] <= 0.f ? 1.f : cum[t];
    float v = __fdiv_rn(__fmul_rn(dv[t], (float)t), c);
    if (t == 0) v = 1.f;
    v = __fmul_rn(v, 32768.f);
    out[t] = v;
    dv[t] = v;                      // kept for the pick's best value
    if (v < thr && t < pk.under) pk.under = t;
    if (v != v) {
      if (t < pk.nan) pk.nan = t;
    } else if (v < pk.vmin || (v == pk.vmin && t < pk.imin)) {
      pk.vmin = v;
      pk.imin = t;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Pick other{__shfl_xor_sync(0xffffffffu, pk.under, o),
               __shfl_xor_sync(0xffffffffu, pk.nan, o),
               __shfl_xor_sync(0xffffffffu, pk.imin, o),
               __shfl_xor_sync(0xffffffffu, pk.vmin, o)};
    merge(pk, other);
  }
  if ((threadIdx.x & 31) == 0) s_pick[threadIdx.x / 32] = pk;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)blockDim.x / 32; ++k) merge(pk, s_pick[k]);
    const int p = pk.under != INT_MAX ? pk.under
                  : (pk.nan != INT_MAX ? pk.nan
                                       : (pk.imin != INT_MAX ? pk.imin : 0));
    *period = p;
    *best = dv[p];
  }
  __syncthreads();                  // s_pick and the buffers free again
}

// kFinish (a frame a block, tiles == 1): the block also finishes its
// frame, one launch; else d(t) goes to cmnd for yin_finish_kernel.
template <int R, typename In, bool kFinish>
__global__ void __launch_bounds__(kDiffThreads)
yin_diff_kernel(const In* __restrict__ frames, float* __restrict__ cmnd,
                int64_t* __restrict__ period, float* __restrict__ best,
                int F, int ndiff, int tiles, int stage, int sstride,
                float thr) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Pick s_pick[kDiffThreads / 32];
  pdl_trigger();
  const int frame = blockIdx.x / tiles;
  const int tile = blockIdx.x - frame * tiles;
  const int tpf = blockDim.x;
  const Tree tr = make_tree(ndiff);
  // staged so that every window of 32 starts on a 16-byte boundary
  float* x = smem + (tr.lo[0] & 3);
  const In* fr = frames + (size_t)frame * F;
  for (int i0 = threadIdx.x; i0 < stage; i0 += kLoadUnroll * tpf) {
    float v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int i = i0 + u * tpf;
      v[u] = i < stage ? (float)fr[min(i, F - 1)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u)
      if (i0 + u * tpf < stage) x[i0 + u * tpf] = v[u];
  }
  __syncthreads();
  const int t0 = (tile * tpf + threadIdx.x) * R;
  const bool active = t0 < ndiff;
  float val[R];
  if (active) lag_sums<R>(x, tr, ndiff, t0, val);
  if (!kFinish) {
    if (active) {
      float* out = cmnd + (size_t)frame * ndiff + t0;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (t0 + k < ndiff) out[k] = val[k];
    }
    return;
  }
  float* dv = smem + sstride;       // [ndiff] d(t), [ndiff] its scan, totals
  if (active) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (t0 + k < ndiff) {
        dv[t0 + k] = val[k];
        dv[ndiff + t0 + k] = val[k];
      }
  }
  __syncthreads();
  finish_frame(dv, dv + ndiff, dv + 2 * ndiff, ndiff, thr,
               cmnd + (size_t)frame * ndiff, period + frame, best + frame,
               s_pick);
}

__global__ void __launch_bounds__(kFinishThreads)
yin_finish_kernel(float* __restrict__ cmnd, int64_t* __restrict__ period,
                  float* __restrict__ best, int ndiff, float thr) {
  extern __shared__ __align__(16) float smem[];
  float* dv = smem;                 // [ndiff]
  float* cum = dv + ndiff;          // [ndiff]
  __shared__ Pick s_pick[kFinishThreads / 32];
  const int row = blockIdx.x;
  float* out = cmnd + (size_t)row * ndiff;
  pdl_wait();                       // d(t) from the diff launch
  for (int t0 = threadIdx.x; t0 < ndiff; t0 += kLoadUnroll * blockDim.x) {
    float v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int t = t0 + u * blockDim.x;
      v[u] = t < ndiff ? out[t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < ndiff) {
        dv[t] = v[u];
        cum[t] = v[u];
      }
    }
  }
  __syncthreads();
  finish_frame(dv, cum, cum + ndiff, ndiff, thr, out, period + row,
               best + row, s_pick);
}

size_t scan_totals(int n) {
  size_t s = 0;
  for (int l = 0; l < kMaxScan && n > kScanBlock; ++l) {
    n = (n + kScanBlock - 1) / kScanBlock;
    s += n;
  }
  return s;
}

struct Layout {
  int R, tpf, tiles, blocks, stage, sstride, fstride;
};

// The launcher's layout, or (R, tpf) where forced (0: its choice); false
// where it cannot run (R not 4 or 8, tpf not 64 or 128, more than
// INT_MAX blocks).  As measured (PERF.md §6): R = 8 from 1,024 lags
// (fewer shared loads a square), R = 4 below (more threads); a frame a
// block of 64 threads, or 128 where its lags need them, and tiles of 64
// threads past that.
bool choose(int N, int ndiff, int R, int tpf, Layout* lay) {
  if (R == 0) R = ndiff >= 1024 ? 8 : 4;
  if (R != 4 && R != 8) return false;
  const int need = (ndiff + R - 1) / R;          // lag groups of a frame
  if (tpf == 0) tpf = need <= 64 || need > 128 ? 64 : 128;
  if (tpf != 64 && tpf != 128) return false;
  const int tiles = (need + tpf - 1) / tpf;
  const long long blocks = (long long)N * tiles;
  const int stage = (2 * ndiff + kStageExtra + 3) / 4 * 4;
  const int fstride =
      (int)((2 * (size_t)ndiff + scan_totals(ndiff) + 3) / 4 * 4);
  *lay = Layout{R, tpf, tiles, (int)blocks, stage, stage + 4, fstride};
  return blocks <= INT_MAX;
}

template <int R, typename In, bool kFinish>
cudaError_t launch_diff(const Layout& lay, const In* frames, float* cmnd,
                        int64_t* period, float* best, int F, int ndiff,
                        float thr, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (lay.sstride + (kFinish ? (size_t)lay.fstride : 0));
  cudaError_t e = cudaFuncSetAttribute(
      yin_diff_kernel<R, In, kFinish>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  yin_diff_kernel<R, In, kFinish><<<lay.blocks, lay.tpf, smem, stream>>>(
      frames, cmnd, period, best, F, ndiff, lay.tiles, lay.stage,
      lay.sstride, thr);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_diff_r(const Layout& lay, const In* frames, float* cmnd,
                          int64_t* period, float* best, int F, int ndiff,
                          float thr, cudaStream_t stream) {
  const bool one = lay.tiles == 1;
  if (lay.R == 8)
    return one ? launch_diff<8, In, true>(lay, frames, cmnd, period, best, F,
                                          ndiff, thr, stream)
               : launch_diff<8, In, false>(lay, frames, cmnd, period, best,
                                           F, ndiff, thr, stream);
  return one ? launch_diff<4, In, true>(lay, frames, cmnd, period, best, F,
                                        ndiff, thr, stream)
             : launch_diff<4, In, false>(lay, frames, cmnd, period, best, F,
                                         ndiff, thr, stream);
}

}  // namespace

extern "C" int sst_yin_cmnd(const void* frames, int is_i16, float* cmnd,
                            int64_t* period, float* best, int N, int F,
                            int ndiff, float thr, int R, int tpf,
                            cudaStream_t stream) {
  if (N <= 0 || ndiff <= 0) return (int)cudaSuccess;
  if (F <= 0 || ndiff > F) return (int)cudaErrorInvalidValue;
  Layout lay;
  if (!choose(N, ndiff, R, tpf, &lay)) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      is_i16 ? launch_diff_r(lay, (const int16_t*)frames, cmnd, period, best,
                             F, ndiff, thr, stream)
             : launch_diff_r(lay, (const float*)frames, cmnd, period, best, F,
                             ndiff, thr, stream);
  if (e != cudaSuccess || lay.tiles == 1) return (int)e;
  // frames cut into lag tiles: the scan and pick in a second launch, the
  // first's programmatic dependent
  const size_t smem =
      sizeof(float) * (2 * (size_t)ndiff + scan_totals(ndiff));
  e = cudaFuncSetAttribute(yin_finish_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N, 1, 1);
  cfg.blockDim = dim3(kFinishThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, yin_finish_kernel, cmnd, period, best, ndiff,
                         thr);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int sst_yin_layout(int N, int ndiff, int R, int tpf,
                              int32_t* layout) {
  Layout lay;
  if (N < 0 || ndiff <= 0 || !choose(N, ndiff, R, tpf, &lay))
    return (int)cudaErrorInvalidValue;
  layout[0] = lay.R;
  layout[1] = lay.tpf;
  layout[2] = lay.tiles;
  layout[3] = lay.blocks;
  layout[4] = lay.tiles == 1 ? 1 : 2;   // launches
  return (int)cudaSuccess;
}
