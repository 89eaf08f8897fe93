// Forms of K5 (csrc/gather_cols.cu) measured against the one it ships,
// by tools/exp_gather_cols.py; the port calls none of them.
//
// * kind 1, "quad": a block a row's tile of `tile` frames; the row's
//   columns wrapped and checked once into a plan in shared memory (-1
//   past the end); the tile's output [nt, S] one contiguous run, 4
//   adjacent outputs a lane written with one int4 store (16-byte
//   aligned: the fewer than 4 outputs before the first aligned address
//   and after the last one by one), `par` quads' loads in flight before
//   their stores; read-only loads from global memory;
// * kind 4, "staged": kind 1 (4 quads in flight) gathering from the
//   tile's source frames, copied first into shared memory with 16-byte
//   cp.async in two groups (the first half gathered while the second
//   lands); whole frames of a multiple of 16 bytes from a 16-byte
//   aligned source, at most 64 KB of them;
// * kind 2, "flat": an output a lane over the tile's outputs in order
//   (4-byte stores), `par` loads in flight, the plan in shared memory;
// * kind 3, "column": the shipped form's mapping (a column a thread,
//   the block the row's columns rounded up to a warp, every frame's load
//   before the stores) at `par` frames a block (the shipped kernel's 8).
#include "../soundswallower_tpu_torch/csrc/sst_kernels.h"

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int plan_bytes(int cols) {
  return (cols * 4 + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row's plan: its columns wrapped once, -1 past the end.
__device__ __forceinline__ void make_plan(int32_t* plan, const int32_t* crow,
                                          int S, int Sx) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int c = crow[s];
    if (c < 0) c += Sx;
    plan[s] = c >= 0 && c < Sx ? c : -1;
  }
}

// Outputs [lo, hi) of a run o of rows of S columns: output l is (row
// l / S, column l % S) and takes val(row, column); 4 adjacent outputs a
// lane, one int4 store each.
template <int kUnroll, typename Val>
__device__ __forceinline__ void gather_run(int32_t* __restrict__ o, int lo,
                                           int hi, int S, Val val) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(o + lo) >> 2) & 3);
  const int a = min(hi, lo + ((4 - mis) & 3));
  const int nq = (hi - a) >> 2;
  const int z = a + 4 * nq;
  const int tid = threadIdx.x;
  if (tid < a - lo) {
    const int l = lo + tid;
    o[l] = val(l / S, l % S);
  } else if (tid >= 4 && tid - 4 < hi - z) {
    const int l = z + tid - 4;
    o[l] = val(l / S, l % S);
  }
  if (tid >= nq) return;
  const int l0 = a + 4 * tid;
  int t = l0 / S, s = l0 - t * S;
  constexpr int kStep = 4 * kThreads;
  const int dt = kStep / S, ds = kStep - dt * S;
  for (int q = tid; q < nq; q += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u * kThreads < nq) {
        int r[4];
        int tt = t, ss = s;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          r[k] = val(tt, ss);
          if (++ss == S) {
            ss = 0;
            ++tt;
          }
        }
        v[u] = make_int4(r[0], r[1], r[2], r[3]);
      }
      t += dt;
      s += ds;
      if (s >= S) {
        s -= S;
        ++t;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q + u * kThreads < nq)
        *reinterpret_cast<int4*>(o + a + 4 * (q + u * kThreads)) = v[u];
  }
}

template <typename Src, bool kStaged, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    k_quad(const Src* __restrict__ src, const int32_t* __restrict__ cols,
           int32_t* __restrict__ out, int T, int Sx, int S, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* plan = reinterpret_cast<int32_t*>(smem);
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int nt = min(tile, T - t0);
  const size_t f0 = (size_t)b * T + t0;
  const Src* frames = src + f0 * Sx;
  Src* stage = reinterpret_cast<Src*>(smem + plan_bytes(S));
  const int half = (nt + 1) / 2;
  if (kStaged) {
    constexpr int kV = 16 / sizeof(Src);
    const int n0 = half * Sx / kV, n1 = nt * Sx / kV;
    for (int i = threadIdx.x; i < n0; i += kThreads)
      cp_async16(stage + kV * i, frames + kV * i);
    cp_async_commit();
    for (int i = n0 + threadIdx.x; i < n1; i += kThreads)
      cp_async16(stage + kV * i, frames + kV * i);
    cp_async_commit();
  }
  make_plan(plan, cols + (size_t)b * S, S, Sx);
  const int32_t fill = sizeof(Src) == 2 ? -32768 : INT32_MIN;
  int32_t* o = out + f0 * S;
  if (kStaged) {
    auto val = [&](int t, int s) -> int32_t {
      const int c = plan[s];
      return c >= 0 ? (int32_t)stage[t * Sx + c] : fill;
    };
    cp_async_wait<1>();
    __syncthreads();
    gather_run<kUnroll>(o, 0, half * S, S, val);
    cp_async_wait<0>();
    __syncthreads();
    gather_run<kUnroll>(o, half * S, nt * S, S, val);
    return;
  }
  __syncthreads();
  gather_run<kUnroll>(o, 0, nt * S, S, [&](int t, int s) -> int32_t {
    const int c = plan[s];
    return c >= 0 ? (int32_t)__ldg(frames + (size_t)t * Sx + c) : fill;
  });
}

template <typename Src, int U>
__global__ void __launch_bounds__(kThreads)
    k_flat(const Src* __restrict__ src, const int32_t* __restrict__ cols,
           int32_t* __restrict__ out, int T, int Sx, int S, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* plan = reinterpret_cast<int32_t*>(smem);
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int nt = min(tile, T - t0);
  const size_t f0 = (size_t)b * T + t0;
  const Src* frames = src + f0 * Sx;
  make_plan(plan, cols + (size_t)b * S, S, Sx);
  __syncthreads();
  const int32_t fill = sizeof(Src) == 2 ? -32768 : INT32_MIN;
  int32_t* o = out + f0 * S;
  const int n = nt * S;
  int t = threadIdx.x / S, s = threadIdx.x - t * S;
  const int dt = kThreads / S, ds = kThreads - dt * S;
  for (int l = threadIdx.x; l < n; l += kThreads * U) {
    int32_t v[U];
    int tt = t, ss = s;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (l + u * kThreads < n) {
        const int c = plan[ss];
        v[u] = c >= 0 ? (int32_t)__ldg(frames + (size_t)tt * Sx + c) : fill;
      }
      tt += dt;
      ss += ds;
      if (ss >= S) {
        ss -= S;
        ++tt;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (l + u * kThreads < n) o[l + u * kThreads] = v[u];
    t = tt;
    s = ss;
  }
}

template <typename Src, int F>
__global__ void k_column(const Src* __restrict__ src,
                         const int32_t* __restrict__ cols,
                         int32_t* __restrict__ out, int T, int Sx, int S) {
  const int b = blockIdx.y, t0 = blockIdx.x * F;
  const int32_t fill = sizeof(Src) == 2 ? -32768 : INT32_MIN;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int c = cols[(size_t)b * S + s];
    if (c < 0) c += Sx;
    const bool ok = c >= 0 && c < Sx;
    int32_t v[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = t0 + k;
      v[k] = t < T && ok ? (int32_t)__ldg(src + ((size_t)b * T + t) * Sx + c)
                         : fill;
    }
#pragma unroll
    for (int k = 0; k < F; ++k)
      if (t0 + k < T) out[((size_t)b * T + t0 + k) * S + s] = v[k];
  }
}

template <typename Src>
int go(int kind, int par, const Src* src, const int32_t* cols, int32_t* out,
       int B, int T, int Sx, int S, int tile, cudaStream_t st) {
  if (kind == 3) {
    const int thr = min(1024, (S + 31) / 32 * 32);
    const dim3 grid((T + par - 1) / par, B);
    if (par == 4)
      k_column<Src, 4><<<grid, thr, 0, st>>>(src, cols, out, T, Sx, S);
    else if (par == 8)
      k_column<Src, 8><<<grid, thr, 0, st>>>(src, cols, out, T, Sx, S);
    else if (par == 16)
      k_column<Src, 16><<<grid, thr, 0, st>>>(src, cols, out, T, Sx, S);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (tile < 1 || S > 8192) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + tile - 1) / tile, B);
  int smem = plan_bytes(S);
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kThreads, smem, st>>>(src, cols, out, T, Sx, S, tile);
    return (int)cudaGetLastError();
  };
  switch (kind * 100 + par) {
    case 101: return launch(k_quad<Src, false, 1>);
    case 102: return launch(k_quad<Src, false, 2>);
    case 104: return launch(k_quad<Src, false, 4>);
    case 204: return launch(k_flat<Src, 4>);
    case 208: return launch(k_flat<Src, 8>);
    case 216: return launch(k_flat<Src, 16>);
  }
  if (kind == 4) {
    const long long frame = (long long)Sx * sizeof(Src);
    if (frame % 16 || (reinterpret_cast<uintptr_t>(src) & 15) ||
        tile * frame > 64 * 1024)
      return (int)cudaErrorInvalidValue;
    smem += (int)(tile * frame);
    return launch(k_quad<Src, true, 4>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int exp_gather(int kind, int par, const void* src, int elem,
                          const int32_t* cols, int32_t* out, int B, int T,
                          int Sx, int S, int tile, cudaStream_t st) {
  if (elem == 2)
    return go(kind, par, static_cast<const int16_t*>(src), cols, out, B, T,
              Sx, S, tile, st);
  return go(kind, par, static_cast<const int32_t*>(src), cols, out, B, T, Sx,
            S, tile, st);
}
