// K13 `backtrace_chunk`: the backtrace over one rank's token chunk.
//
// Replaces _backward's chunk_back (soundswallower_tpu/parallel/seqpipe.py
// :188-196) of the TPU program B12 (align_longform): each device of the
// ('seq',) mesh walked its own [C, S] token chunk backwards from the
// state the next device handed it, as a lax.scan of C steps inside a
// reverse wavefront over the ring.  Here a launch walks R rows of one
// rank's chunk [R, C, S]:
//   for t = t0+C-1 down to t0:  path[t-t0] = t < n ? cid : -1;
//                               cid = t < n-1 ? tok[t-t0, cid] : cid
// and hands back the state that leaves the chunk (the next rank's start).
// A negative state wraps once and then clamps, as jnp indexing does
// (ops/align_torch.py _backtrace_single); raw states, negative ones
// included, are what the path records and what the next rank receives.
//
// Bound: latency.  Each step is one dependent 2- or 4-byte load (the
// next address is the value just loaded), so one walk of the chunk is a
// chain of C round trips to HBM, whatever the card's width: 832 frames
// took 0.37 ms as one thread a row.  The function's bytes are the path
// (R*C*4) plus the C tokens it reads a row.
//
// Design: a segmented backtrace, whose serial chains do not grow with C.
// The launcher cuts the chunk into K segments of L frames (about sqrt(C),
// backtrace_segment_len) and makes two launches:
//  1. backtrace_maps_kernel: for every row, segment k and state a in
//     [0, S), the state that leaves segment k when a enters it,
//     M[r, k, a] (raw).  Every frame of a segment at which t < n - 1
//     looks up, and those are the segment's lowest frames, so the first
//     lookup reads tok[top, a] for the entering state's wrapped and
//     clamped index a, and the map over [0, S) covers every raw state.
//     R*K*S independent chains of at most L loads, four a thread: they
//     read the chunk once, a block's chains a row at a time, so the row
//     comes from HBM once and its other reads hit L1.  A segment with no
//     lookup (every frame at or past n - 1) maps every state to itself
//     and writes nothing.
//  2. backtrace_walk_kernel, a block a row: one thread composes the
//     maps from the row's start, K lookups in L2, and records the raw
//     state that enters each segment in shared memory; then thread k
//     walks segment k's L frames from it by the per-step rule above,
//     writing the path, and thread 0 writes the state leaving the chunk.
// So the serial chains are L (phase 1), K (the composition) and L (the
// walk) long.  Where one chain of C steps costs less than the two
// launches (a short chunk, or phase 1's read of R*C*S tokens longer than
// the walk it saves), L = C: one segment, no maps, and the walk kernel
// alone is the one-chain walk.  The caller passes L (the wrapper takes
// backtrace_segment_len's) and the maps' scratch [R, K, S] int32.
#include <math.h>

#include "sst_kernels.h"

namespace {

constexpr int kMapThreads = 256;    // phase 1: threads a block
constexpr int kMapStates = 4;       // phase 1: chains a thread walks at once
constexpr int kMaxSegments = 1024;  // phase 2: a thread a segment
// the launcher's cost estimates (ns; H100): a dependent load from HBM,
// one from L2, the HBM rate in bytes a ns, a second launch
constexpr double kHbmNs = 450.0;
constexpr double kL2Ns = 200.0;
constexpr double kBytesPerNs = 3000.0;
constexpr double kLaunchNs = 4000.0;

// the index a raw state reads its token at: wrapped once, clamped
__device__ __forceinline__ int tok_index(int32_t cid, int S) {
  const int32_t at = cid < 0 ? cid + S : cid;
  return at < 0 ? 0 : (at > S - 1 ? S - 1 : at);
}

// the highest frame of [lo, hi) at which a row of n frames looks up (the
// frames below it look up too), lo - 1 where none does
__device__ __forceinline__ int first_lookup(int hi, int n, int t0) {
  return min(hi - 1, n - 2 - t0);
}

template <typename Tok>
__global__ void __launch_bounds__(kMapThreads) backtrace_maps_kernel(
    const Tok* __restrict__ tok, const int32_t* __restrict__ n_frames,
    int32_t* __restrict__ maps, int C, int S, int t0, int L, int K) {
  const int r = blockIdx.x, k = blockIdx.y;
  const int lo = k * L;
  const int top = first_lookup(min(lo + L, C), n_frames[r], t0);
  if (top < lo) return;  // no lookup: the identity, which phase 2 applies
  const Tok* const tk = tok + (size_t)r * C * S;
  const int a0 = blockIdx.z * (kMapThreads * kMapStates) + threadIdx.x;
  int32_t x[kMapStates];
#pragma unroll
  for (int i = 0; i < kMapStates; ++i)
    x[i] = min(a0 + i * kMapThreads, S - 1);
  for (int c = top; c >= lo; --c) {
    const Tok* const row = tk + (size_t)c * S;
#pragma unroll
    for (int i = 0; i < kMapStates; ++i)
      x[i] = (int32_t)__ldg(row + tok_index(x[i], S));
  }
  int32_t* const m = maps + ((size_t)r * K + k) * S;
#pragma unroll
  for (int i = 0; i < kMapStates; ++i) {
    const int a = a0 + i * kMapThreads;
    if (a < S) m[a] = x[i];
  }
}

template <typename Tok>
__global__ void __launch_bounds__(kMaxSegments) backtrace_walk_kernel(
    const Tok* __restrict__ tok, const int32_t* __restrict__ start,
    const int32_t* __restrict__ n_frames, const int32_t* __restrict__ maps,
    int32_t* __restrict__ path, int32_t* __restrict__ out_state, int C,
    int S, int t0, int L, int K) {
  __shared__ int32_t enter[kMaxSegments];
  const int r = blockIdx.x;
  const int n = n_frames[r];
  if (threadIdx.x == 0) {
    // the raw state entering each segment, from the last one down
    int32_t x = start[r];
    for (int k = K - 1; k > 0; --k) {
      enter[k] = x;
      if (first_lookup(min(k * L + L, C), n, t0) >= k * L)
        x = maps[((size_t)r * K + k) * S + tok_index(x, S)];
    }
    enter[0] = x;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= K) return;
  const Tok* const tk = tok + (size_t)r * C * S;
  int32_t* const pr = path + (size_t)r * C;
  const int lo = k * L, hi = min(lo + L, C);
  int32_t cid = enter[k];
  for (int c = hi - 1; c >= lo; --c) {
    const int t = t0 + c;
    pr[c] = t < n ? cid : -1;
    if (t < n - 1) cid = (int32_t)tk[(size_t)c * S + tok_index(cid, S)];
  }
  if (k == 0) out_state[r] = cid;
}

template <typename Tok>
int launch(const Tok* tok, const int32_t* start, const int32_t* n_frames,
           int32_t* path, int32_t* out_state, int32_t* maps, int R, int C,
           int S, int t0, int L, int K, cudaStream_t stream) {
  if (K > 1) {
    const int per_block = kMapThreads * kMapStates;
    const int state_blocks = (S + per_block - 1) / per_block;
    if (state_blocks > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)R, (unsigned)K, (unsigned)state_blocks);
    backtrace_maps_kernel<Tok><<<grid, kMapThreads, 0, stream>>>(
        tok, n_frames, maps, C, S, t0, L, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (K + 31) & ~31;
  backtrace_walk_kernel<Tok><<<(unsigned)R, threads, 0, stream>>>(
      tok, start, n_frames, maps, path, out_state, C, S, t0, L, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The segment length the wrapper takes: about sqrt(C), at least
// ceil(C / 1024) (a thread a segment in phase 2), or C (one segment,
// the one-chain walk) where the estimated two launches take longer than
// one chain of C loads from HBM: a short chunk, or one whose R*C*S
// tokens phase 1 reads take longer than the walk it saves.  Both sides
// win somewhere (chip_smoke.py times the form not taken in turns with
// the one taken; H100 80GB HBM3 at 700 W): R=8, C=40, S=39,477 int32
// keeps one chain, 0.0206 ms against 0.0222 for segments of 7 frames;
// R=4, C=832, S=3,714 int16 takes segments of 29, 0.0385 ms against
// 0.3198 for one chain.
extern "C" int sst_backtrace_segment_len(int R, int C, int S, int tok_bytes) {
  if (C < 2) return C < 1 ? 1 : C;
  int L = (int)ceil(sqrt((double)C));
  L = L > (C + kMaxSegments - 1) / kMaxSegments
          ? L
          : (C + kMaxSegments - 1) / kMaxSegments;
  const int K = (C + L - 1) / L;
  const double chain = C * kHbmNs;
  const double maps = fmax((double)R * C * S * tok_bytes / kBytesPerNs,
                           L * kHbmNs);
  const double segmented = maps + (K + L) * kL2Ns + kLaunchNs;
  return segmented < chain ? L : C;
}

extern "C" int sst_backtrace_chunk(const void* tok, int tok_bytes,
                                   const int32_t* start,
                                   const int32_t* n_frames, int32_t* path,
                                   int32_t* out_state, int32_t* maps, int R,
                                   int C, int S, int t0, int L,
                                   cudaStream_t stream) {
  if (tok_bytes != 2 && tok_bytes != 4) return (int)cudaErrorInvalidValue;
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  if (S <= 0 || L < 1) return (int)cudaErrorInvalidValue;
  const int K = (C + L - 1) / L;
  if (K > kMaxSegments) return (int)cudaErrorInvalidValue;
  return tok_bytes == 2
             ? launch((const int16_t*)tok, start, n_frames, path, out_state,
                      maps, R, C, S, t0, L, K, stream)
             : launch((const int32_t*)tok, start, n_frames, path, out_state,
                      maps, R, C, S, t0, L, K, stream);
}
