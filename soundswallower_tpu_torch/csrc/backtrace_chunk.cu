// K13 `backtrace_chunk`: the backtrace over one rank's token chunk.
//
// Replaces _backward's chunk_back (soundswallower_tpu/parallel/seqpipe.py
// :188-196) of the TPU program B12 (align_longform): each device of the
// ('seq',) mesh walked its own [C, S] token chunk backwards from the
// state the next device handed it, as a lax.scan of C steps inside a
// reverse wavefront over the ring.  Here a launch walks R rows of one
// rank's chunk [R, C, S], one thread per row:
//   for t = t0+C-1 down to t0:  path[t-t0] = t < n ? cid : -1;
//                               cid = t < n-1 ? tok[t-t0, cid] : cid
// and hands back the state that leaves the chunk (the next rank's start).
// A negative state wraps once and then clamps, as jnp indexing does
// (ops/align_torch.py _backtrace_single).
//
// Bound: latency.  Each step is one dependent 2- or 4-byte load from the
// token chunk (the next address depends on the value loaded), so a row
// costs C round trips to L2 or HBM; rows run in parallel.  The bytes the
// function must move are the path (R*C*4) plus the C tokens it reads per
// row.  Making it faster (prefetching the chunk's candidate tokens into
// shared memory, several rows per warp) is later work.
#include "sst_kernels.h"

namespace {

template <typename Tok>
__global__ void backtrace_chunk_kernel(const Tok* __restrict__ tok,
                                       const int32_t* __restrict__ start,
                                       const int32_t* __restrict__ n_frames,
                                       int32_t* __restrict__ path,
                                       int32_t* __restrict__ out_state, int R,
                                       int C, int S, int t0) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Tok* tk = tok + (size_t)r * C * S;
  int32_t* pr = path + (size_t)r * C;
  const int n = n_frames[r];
  int32_t cid = start[r];
  for (int c = C - 1; c >= 0; --c) {
    const int t = t0 + c;
    pr[c] = t < n ? cid : -1;
    if (t < n - 1) {
      int32_t at = cid < 0 ? cid + S : cid;
      at = at < 0 ? 0 : (at > S - 1 ? S - 1 : at);
      cid = (int32_t)tk[(size_t)c * S + at];
    }
  }
  out_state[r] = cid;
}

}  // namespace

extern "C" int sst_backtrace_chunk(const void* tok, int tok_bytes,
                                   const int32_t* start,
                                   const int32_t* n_frames, int32_t* path,
                                   int32_t* out_state, int R, int C, int S,
                                   int t0, cudaStream_t stream) {
  if (tok_bytes != 2 && tok_bytes != 4) return (int)cudaErrorInvalidValue;
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  if (tok_bytes == 2) {
    backtrace_chunk_kernel<int16_t><<<blocks, threads, 0, stream>>>(
        (const int16_t*)tok, start, n_frames, path, out_state, R, C, S, t0);
  } else {
    backtrace_chunk_kernel<int32_t><<<blocks, threads, 0, stream>>>(
        (const int32_t*)tok, start, n_frames, path, out_state, R, C, S, t0);
  }
  return (int)cudaGetLastError();
}
