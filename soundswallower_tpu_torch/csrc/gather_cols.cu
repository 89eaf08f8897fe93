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
// Bound: memory.  Each block owns one row b and a run of frames: a
// thread reads its columns' indices once and then, frame by frame,
// gathers from the row's frame (a few KB, in L1/L2) and writes
// coalesced int32.  Folding the gather into K3's output write (ROADMAP
// B6) is left to a later change.
#include "sst_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerBlock = 8;

template <typename Src>
__global__ void gather_cols_kernel(const Src* __restrict__ src,
                                   const int32_t* __restrict__ cols,
                                   int32_t* __restrict__ out, int T, int Sx,
                                   int S) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFramesPerBlock;
  const int t1 = min(T, t0 + kFramesPerBlock);
  const int32_t fill = sizeof(Src) == 2 ? -32768 : INT32_MIN;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int c = cols[(size_t)b * S + s];
    if (c < 0) c += Sx;
    const bool ok = c >= 0 && c < Sx;
    for (int t = t0; t < t1; ++t) {
      const size_t bt = (size_t)b * T + t;
      out[bt * S + s] = ok ? (int32_t)src[bt * Sx + c] : fill;
    }
  }
}

}  // namespace

extern "C" int sst_gather_cols(const void* src, int elem_bytes,
                               const int32_t* cols, int32_t* out, int B,
                               int T, int Sx, int S, cudaStream_t stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaSuccess;
  if (Sx <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kFramesPerBlock - 1) / kFramesPerBlock, B);
  if (elem_bytes == 2)
    gather_cols_kernel<int16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int16_t*>(src), cols, out, T, Sx, S);
  else
    gather_cols_kernel<int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(src), cols, out, T, Sx, S);
  return (int)cudaGetLastError();
}
