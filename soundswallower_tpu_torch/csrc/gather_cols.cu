// K5 `gather_cols`: the mixed batch's per-row column gather,
// out[b, t, s] = src[b, t, cols[b, s]], from an int32 source (the union
// scorer's [B, T, Spad] scores) or an int16 one (the full-inventory
// scorer's [B, T, n_sen] scores), widened to int32.
//
// Replaces the jitted XLA program of soundswallower_tpu/aligner.py
// _gather_cols (jnp.take_along_axis), part of B6, with its index rule:
// a negative column wraps once (the union's pad nodes carry -1 when
// senone 0 is not in the working set), and a column past the end reads
// the source type's minimum.
//
// Bound: memory.  The output (4 bytes a column and frame) is written in
// full; of the source a gather cannot read less than the 32-byte sectors
// its columns touch (chip_smoke.py prints that floor beside the bound).
// Design (redesigned for Hopper, PERF.md §6):
// * a block owns one row b and kFrames frames; a thread owns a column:
//   it reads, wraps and checks the column once (the row's plan, held in
//   a register), then issues every frame's read-only load before its
//   stores, so kFrames loads are in flight a thread;
// * the block is the row's columns rounded up to a warp (at most 1,024
//   threads): every lane is busy at the paths' S = 288 (9 warps), where
//   256 threads left 224 idle in a second pass;
// * a warp's store is 32 adjacent int32 of one frame (128 bytes).
// The forms measured against it and dropped (a plan in shared memory
// with 4 adjacent outputs a lane and int4 stores, gathered from global
// memory or from the tile's frames staged by cp.async; an output a lane
// over a flat tile; 4 or 16 frames a block) are in
// tools/exp_gather_cols.cu, with their times.
#include "sst_kernels.h"

namespace {

constexpr int kFrames = 8;
constexpr int kMaxThreads = 1024;

int gather_threads(int S) {
  const int warps = (S + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

template <typename Src>
__global__ void __launch_bounds__(kMaxThreads)
    gather_cols_kernel(const Src* __restrict__ src,
                       const int32_t* __restrict__ cols,
                       int32_t* __restrict__ out, int T, int Sx, int S) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int32_t fill = sizeof(Src) == 2 ? -32768 : INT32_MIN;
  const size_t f0 = (size_t)b * T + t0;  // the block's first frame
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int c = cols[(size_t)b * S + s];
    if (c < 0) c += Sx;
    const bool ok = c >= 0 && c < Sx;
    int32_t v[kFrames];
#pragma unroll
    for (int k = 0; k < kFrames; ++k)
      v[k] = ok && t0 + k < T ? (int32_t)__ldg(src + (f0 + k) * Sx + c)
                              : fill;
#pragma unroll
    for (int k = 0; k < kFrames; ++k)
      if (t0 + k < T) out[(f0 + k) * S + s] = v[k];
  }
}

}  // namespace

extern "C" int sst_gather_cols_layout(int S, int32_t* layout) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  layout[0] = gather_threads(S);
  layout[1] = kFrames;
  return (int)cudaSuccess;
}

extern "C" int sst_gather_cols(const void* src, int elem_bytes,
                               const int32_t* cols, int32_t* out, int B,
                               int T, int Sx, int S, cudaStream_t stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaSuccess;
  if (Sx <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  const int threads = gather_threads(S);
  if (elem_bytes == 2)
    gather_cols_kernel<int16_t><<<grid, threads, 0, stream>>>(
        static_cast<const int16_t*>(src), cols, out, T, Sx, S);
  else
    gather_cols_kernel<int32_t><<<grid, threads, 0, stream>>>(
        static_cast<const int32_t*>(src), cols, out, T, Sx, S);
  return (int)cudaGetLastError();
}
