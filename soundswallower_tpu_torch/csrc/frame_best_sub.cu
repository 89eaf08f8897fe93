// K7 `frame_best_sub`: the per-frame tail of the full-inventory ptm and
// semi scorers.  in int32 [N, S] mixture scores (S = n_sen, senone
// order) -> out int16 [N, S]: each score cast to int16, minus (ptm,
// sub = 1) the int16 cast of the frame's minimum int32 score, the
// subtraction wrapping in int16; semi (sub = 0) is the cast alone
// (s2_semi_mgau.c:826-875 subtracts nothing).
//
// Replaces the tail of B7, soundswallower_tpu/ops/senscore_jax.py
// _sen_eval (:301-309): XLA's int32->int16 convert wraps, the best is
// the minimum over real senones taken on the int32 values, and ptm
// subtracts it (ptm_mgau.c:397-400).  In senone order every column is a
// real senone, so the grouped layout's valid mask is all true here.
//
// Bound: memory, 6 bytes per score.  Where the input is 16-byte and the
// output 8-byte aligned, a score is read as one of four in a 16-byte
// load and written as one of four in an 8-byte store; elsewhere one by
// one.
// * semi: the cast is elementwise over the N x S scores, so the kernel
//   walks the flat array by grid stride, two 16-byte loads in flight
//   per thread, over a grid that fills every SM once.
// * ptm: one block per frame.  Its row (S = 5,126 at en-us width: 20.5
//   KB, most rows off a 16-byte boundary since S is not a multiple of 4)
//   is a scalar head up to the first 16-byte boundary, whole 16-byte
//   vectors, and a scalar tail.  Each thread keeps its first kHeld
//   vectors in registers while the block takes the minimum, so a score
//   is read from HBM once; vectors past kHeld x kThreads (S > 8,192),
//   the head and the tail are read again for the write.
#include <algorithm>

#include "sst_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 8;         // 16-byte vectors a thread holds (ptm)
constexpr int kUnroll = 2;       // 16-byte loads in flight a thread (semi)

__device__ __forceinline__ short4 cast_sub(int4 v, int16_t best) {
  return make_short4((int16_t)((int16_t)v.x - best),
                     (int16_t)((int16_t)v.y - best),
                     (int16_t)((int16_t)v.z - best),
                     (int16_t)((int16_t)v.w - best));
}

__device__ __forceinline__ int min4(int4 v) {
  return min(min(v.x, v.y), min(v.z, v.w));
}

__global__ void __launch_bounds__(kThreads)
frame_best_sub_cast_kernel(const int32_t* __restrict__ in,
                           int16_t* __restrict__ out, int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    // kUnroll 16-byte loads in flight before their stores
    const int4* in4 = reinterpret_cast<const int4*>(in);
    short4* out4 = reinterpret_cast<short4*>(out);
    const int64_t n4 = n >> 2;
    for (int64_t k = i0; k < n4; k += kUnroll * stride) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + u * stride < n4) v[u] = in4[k + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + u * stride < n4) out4[k + u * stride] = cast_sub(v[u], 0);
    }
    done = n4 << 2;
  }
  for (int64_t k = done + i0; k < n; k += stride) out[k] = (int16_t)in[k];
}

__global__ void __launch_bounds__(kThreads)
frame_best_sub_row_kernel(const int32_t* __restrict__ in,
                          int16_t* __restrict__ out, int S, int vec) {
  __shared__ int32_t wmin[kThreads / 32];
  const int64_t r0 = (int64_t)blockIdx.x * S;
  const int32_t* row = in + r0;
  int16_t* orow = out + r0;
  // [0, h): the head; [h, h + 4 nv): nv vectors; the rest: the tail
  int h = S, nv = 0;
  if (vec) {
    h = min(S, (int)((4 - (r0 & 3)) & 3));
    nv = (S - h) >> 2;
  }
  const int t0 = h + 4 * nv;
  const int4* row4 = reinterpret_cast<const int4*>(row + h);
  short4* orow4 = reinterpret_cast<short4*>(orow + h);
  int4 held[kHeld];
  int32_t m = INT32_MAX;
#pragma unroll
  for (int q = 0; q < kHeld; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < nv) {
      held[q] = row4[k];
      m = min(m, min4(held[q]));
    }
  }
  for (int k = threadIdx.x + kHeld * kThreads; k < nv; k += kThreads)
    m = min(m, min4(row4[k]));
  for (int s = threadIdx.x; s < h; s += kThreads) m = min(m, row[s]);
  for (int s = t0 + threadIdx.x; s < S; s += kThreads) m = min(m, row[s]);
  m = __reduce_min_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = m;
  __syncthreads();
  m = INT32_MAX;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = min(m, wmin[w]);
  const int16_t best = (int16_t)m;
#pragma unroll
  for (int q = 0; q < kHeld; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < nv) orow4[k] = cast_sub(held[q], best);
  }
  for (int k = threadIdx.x + kHeld * kThreads; k < nv; k += kThreads)
    orow4[k] = cast_sub(row4[k], best);
  for (int s = threadIdx.x; s < h; s += kThreads)
    orow[s] = (int16_t)((int16_t)row[s] - best);
  for (int s = t0 + threadIdx.x; s < S; s += kThreads)
    orow[s] = (int16_t)((int16_t)row[s] - best);
}

}  // namespace

extern "C" int sst_frame_best_sub(const int32_t* in, int16_t* out, int N,
                                  int S, int sub, cudaStream_t stream) {
  if (N <= 0 || S <= 0) return (int)cudaSuccess;
  const int vec = ((uintptr_t)in & 15) == 0 && ((uintptr_t)out & 7) == 0;
  if (sub) {
    frame_best_sub_row_kernel<<<N, kThreads, 0, stream>>>(in, out, S, vec);
  } else {
    const int64_t n = (int64_t)N * S;
    const int64_t per = vec ? 4 * kUnroll : 1;   // scores a thread's step
    const int64_t need = (n + per * kThreads - 1) / (per * kThreads);
    static const int fill =
        sst_fill_blocks(frame_best_sub_cast_kernel, kThreads);
    const int blocks = (int)std::min<int64_t>(std::max<int64_t>(need, 1),
                                              fill);
    frame_best_sub_cast_kernel<<<blocks, kThreads, 0, stream>>>(in, out, n,
                                                                vec);
  }
  return (int)cudaGetLastError();
}
