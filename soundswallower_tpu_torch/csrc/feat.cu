// K1 `feat`: wire dequant + batch CMN + 1s_c_d_dd dynamic features.
//
// Replaces the jitted XLA program B1 of the JAX package:
// soundswallower_tpu/fe/feat.py feats_full_utt (with cmn_batch and
// compute_feat_1s_c_d_dd), fed by the byte-plane dequant of
// soundswallower_tpu/aligner.py _feats_chunk_planes.feat_one, or (the
// f32 form, sst_feat_f32) by the device front end's float32 cepstra, as
// in _feats_chunk_raw.fe_one.
//
// Bound: bytes for the batch's rows (each row reads 2*T*ncep bytes, or
// 4*T*ncep in the f32 form, and writes 12*T*ncep); for a long row, the
// latency of the CMN sum.  That sum is a float32 fold in frame order
// (the reference's lax.scan, cmn.c:159-225): ncep chains of T dependent
// adds a row, about 4 cycles a frame, whatever the card's width.
//
// The fold: a block of 512 threads per `rows` rows (1 or 2).  Warp 0
// runs the chains, 16 lanes a row (a lane a dimension; past 32 dimensions
// a lane runs the chains of l, l + 32, ... one after another), and reads
// shared memory only; the
// other 15 warps stage a pass of `pass` frames (dequantized, 16-byte
// loads where the rows are aligned, eight loads in flight a thread),
// stored dimension-major with the frames of c0 < 0 set to -0.0 (which
// leaves a float32 sum unchanged), while the chains fold the pass
// before (two buffers, one barrier a pass).  A chain reads its
// dimension's frames as 16-byte vectors a group of 16 ahead of its adds,
// so it runs at the add's latency.
//
// A batch of rows of at most one pass (32 rows or more) takes one
// launch: a fold block also keeps the staged row frame-major with 3
// frames each side (row 0 before the start, row n-1 at and after n),
// subtracts the mean and writes [T, 3, ncep] with 16-byte stores.  Fewer
// rows, or longer ones, take two: the fold writes the means [B, ncep],
// then a block per (frame tile, row) stages its tile and halo, subtracts
// and writes; that second launch is the fold's programmatic dependent,
// so it stages its tile while the fold runs and waits on the grid
// dependency only before reading the means.  Without CMN only the tiled
// launch runs.  Every float op is an explicit round-to-nearest
// intrinsic: the output is bit-equal to the JAX program's.
#include <algorithm>
#include <cstdint>

#include "sst_kernels.h"

namespace {

constexpr int kWin = 3;              // frames each side of a frame
constexpr int kMaxNcep = 128;        // dimensions a frame
constexpr int kChains = kMaxNcep / 32;  // chains a lane past 32 dimensions
constexpr int kFoldThreads = 512;    // warp 0 folds, warps 1-15 stage
constexpr int kStagers = kFoldThreads - 32;
constexpr int kMaxRows = 2;          // rows a fold block
constexpr int kPassMax = 1024;       // frames a pass of a long row
constexpr int kGroup = 16;           // frames a chain adds a step
constexpr int kOutThreads = 128;
constexpr int kMaxTile = 256;
constexpr int kFusedRows = 32;       // rows from which one launch is taken
constexpr int kUnroll = 8;           // loads in flight a thread

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kStagers) : "memory");
}

// (frame, dimension) of an element index, moved on by (dt, dl)
__device__ __forceinline__ void advance(int& t, int& l, int dt, int dl,
                                        int ncep) {
  t += dt;
  l += dl;
  if (l >= ncep) {
    l -= ncep;
    ++t;
  }
}

__device__ __forceinline__ float dequant(uint8_t lo, uint8_t hi, float inv) {
  // (int8(hi) << 8 | lo): the low byte of hi*256 is zero, so | == +
  return __fmul_rn((float)((int)(int8_t)hi * 256 + (int)lo), inv);
}

// A row's cepstral value i (frame i / ncep, dimension i % ncep):
// dequantized from the byte planes, or read from float32 cepstra; V = 4
// reads four at once (i a multiple of 4, the row 4-byte aligned for the
// planes, 16-byte aligned for float32).
struct Planes {
  const uint8_t* lo;
  const uint8_t* hi;
  float inv_scale;
  __device__ __forceinline__ float operator()(size_t i) const {
    return dequant(lo[i], hi[i], inv_scale);
  }
  template <int V>
  __device__ __forceinline__ void load(size_t i, float* v) const {
    if constexpr (V == 4) {
      const uchar4 a = *reinterpret_cast<const uchar4*>(lo + i);
      const uchar4 h = *reinterpret_cast<const uchar4*>(hi + i);
      v[0] = dequant(a.x, h.x, inv_scale);
      v[1] = dequant(a.y, h.y, inv_scale);
      v[2] = dequant(a.z, h.z, inv_scale);
      v[3] = dequant(a.w, h.w, inv_scale);
    } else {
      v[0] = (*this)(i);
    }
  }
  __device__ __forceinline__ Planes row(size_t off) const {
    return Planes{lo + off, hi + off, inv_scale};
  }
};

struct Cep {
  const float* c;
  __device__ __forceinline__ float operator()(size_t i) const { return c[i]; }
  template <int V>
  __device__ __forceinline__ void load(size_t i, float* v) const {
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(c + i);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else {
      v[0] = c[i];
    }
  }
  __device__ __forceinline__ Cep row(size_t off) const { return Cep{c + off}; }
};

// Stage frames [t0, t0 + nraw) of a row: dimension-major into tr
// (tr[l * lstride + t]) and, where raw is not null, frame-major into raw
// (raw[t * ncep + l]).  The staging warps load kUnroll vectors of V at a
// time; then (after their own barrier) a thread a frame sets the frames
// at or past nvalid, those with c0 < 0 (or NaN) and those up to a whole
// group to -0.0 in tr, and counts the others.
template <int V, typename Src>
__device__ void stage_pass(const Src& row, int t0, int nraw, int nvalid,
                           int ncep, int lstride, float* tr, float* raw,
                           int st, int& cnt) {
  const int total = nraw * ncep;
  const size_t base = (size_t)t0 * ncep;
  const int step = V * kStagers;
  const int dt = step / ncep, dl = step - dt * ncep;
  int e0 = V * st;
  int t = e0 / ncep, l = e0 - t * ncep;
  for (; e0 < total; e0 += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * step;
      if (e + V <= total) {
        row.template load<V>(base + e, v[u]);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q)
          v[u][q] = e + q < total ? row(base + e + q) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * step;
      int tt = t, ll = l;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (e + q < total) {
          tr[ll * lstride + tt] = v[u][q];
          if (raw) raw[e + q] = v[u][q];
        }
        advance(tt, ll, 0, 1, ncep);
      }
      advance(t, l, dt, dl, ncep);
    }
  }
  stagers_sync();
  const int ng = (nraw + kGroup - 1) / kGroup * kGroup;
  for (int f = st; f < ng; f += kStagers) {
    if (f < nvalid && tr[f] >= 0.f) {
      ++cnt;
    } else {
      for (int k = 0; k < ncep; ++k) tr[k * lstride + f] = -0.f;
    }
  }
}

// One chain over ng frames (a multiple of kGroup) of one dimension, q
// 16-byte aligned, in frame order: a group's four 16-byte loads are in
// flight while the previous group's 16 adds run.
__device__ __forceinline__ float fold(const float* q, int ng, float s) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4 cur[kGroup / 4], nxt[kGroup / 4];
  if (ng > 0) {
#pragma unroll
    for (int u = 0; u < kGroup / 4; ++u) cur[u] = q4[u];
  }
  for (int g = 0; g < ng; g += kGroup) {
    if (g + kGroup < ng) {
#pragma unroll
      for (int u = 0; u < kGroup / 4; ++u)
        nxt[u] = q4[(g + kGroup) / 4 + u];
    }
#pragma unroll
    for (int u = 0; u < kGroup / 4; ++u) {
      s = __fadd_rn(s, cur[u].x);
      s = __fadd_rn(s, cur[u].y);
      s = __fadd_rn(s, cur[u].z);
      s = __fadd_rn(s, cur[u].w);
    }
#pragma unroll
    for (int u = 0; u < kGroup / 4; ++u) cur[u] = nxt[u];
  }
  return s;
}

// Write nt frames of features [nt, 3, ncep] to o from xs, the cepstra
// (mean subtracted) of padded frames t - 3 .. t + nt + 2, frame-major;
// 16-byte stores where o is aligned.
__device__ void emit(const float* xs, int nt, int ncep, float* o, int tid,
                     int nthreads) {
  const int width = 3 * ncep;
  const int total = nt * width;
  // output i: frame t = i / width, q = (i % width) / ncep, dimension l
  auto value = [&](int t, int q, int l) -> float {
    const float* c = xs + t * ncep + l;          // c[k * ncep]: t' = t+k-3
    if (q == 0) return c[3 * ncep];
    if (q == 1) return __fsub_rn(c[5 * ncep], c[ncep]);
    return __fsub_rn(__fsub_rn(c[6 * ncep], c[2 * ncep]),
                     __fsub_rn(c[4 * ncep], c[0]));
  };
  int i0 = 0;
  if (((uintptr_t)o & 15) == 0) {
    const int n4 = total / 4;
    for (int j = tid; j < n4; j += nthreads) {
      int t = 4 * j / width;
      int rem = 4 * j - t * width;
      int q = rem / ncep;
      int l = rem - q * ncep;
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[u] = value(t, q, l);
        if (++l == ncep) {
          l = 0;
          if (++q == 3) {
            q = 0;
            ++t;
          }
        }
      }
      reinterpret_cast<float4*>(o)[j] = make_float4(w[0], w[1], w[2], w[3]);
    }
    i0 = 4 * n4;
  }
  for (int i = i0 + tid; i < total; i += nthreads) {
    const int t = i / width;
    const int rem = i - t * width;
    const int q = rem / ncep;
    o[i] = value(t, q, rem - q * ncep);
  }
}

// The fold of `rows` rows a block.  kFused (a row of one pass): the
// block also writes the rows' features; else the means.  C chains a
// lane: 1 up to 32 dimensions, else kChains.
template <typename Src, int V, bool kFused, int C>
__global__ void __launch_bounds__(kFoldThreads)
feat_fold_kernel(Src src, const int32_t* __restrict__ n_frames,
                 float* __restrict__ mean, float* __restrict__ out, int B,
                 int T, int ncep, int rows, int pass) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_cnt[kMaxRows];
  __shared__ float s_mean[kMaxRows][kMaxNcep];
  pdl_trigger();
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * rows;
  const int nr = min(rows, B - b0);
  int nf[kMaxRows], nraw[kMaxRows];
  int nmax = 0;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    nf[r] = r < nr ? min(max(n_frames[b0 + r], 0), T) : 0;
    // the fused form also stages frame 0 of a row of no frames: its
    // features replicate it
    nraw[r] = kFused && r < nr ? max(nf[r], 1) : nf[r];
    nmax = max(nmax, nraw[r]);
  }
  if (tid < kMaxRows) s_cnt[tid] = 0;

  const int lstride = pass + 4;                 // a dimension's frames
  // per row: tr [ncep][lstride], then (fused) xs [T + 6][ncep]
  const int pstride = kFused ? ((T + 2 * kWin) * ncep + 3) / 4 * 4 : 0;
  const int rstride = ncep * lstride + pstride;
  const int bstride = rows * rstride;
  const int npass = (nmax + pass - 1) / pass;
  int cnt[kMaxRows] = {0, 0};
  auto stage = [&](int p) {
    float* buf = sm + (p & 1) * bstride;
    for (int r = 0; r < nr; ++r)
      stage_pass<V>(src.row((size_t)(b0 + r) * T * ncep), p * pass,
                    min(pass, nraw[r] - p * pass), nf[r] - p * pass, ncep,
                    lstride, buf + r * rstride,
                    kFused ? buf + r * rstride + ncep * lstride + kWin * ncep
                           : nullptr,
                    tid - 32, cnt[r]);
  };
  if (tid >= 32 && npass > 0) stage(0);
  __syncthreads();

  const int lpr = ncep <= 16 ? 16 : 32;         // lanes a row
  const int cr = tid / lpr, cl = tid - (tid / lpr) * lpr;
  // the lane's chains: dimensions cl, cl + lpr, ... below ncep
  const bool chain = tid < 32 && cr < nr && cl < ncep;
  float s[C] = {};
  for (int p = 0; p < npass; ++p) {
    if (tid < 32) {
      if (chain) {
        const int k = min(pass, nraw[cr] - p * pass);
        const int ng = k > 0 ? (k + kGroup - 1) / kGroup * kGroup : 0;
        const float* q = sm + (p & 1) * bstride + cr * rstride;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (cl + c * lpr < ncep)
            s[c] = fold(q + (cl + c * lpr) * lstride, ng, s[c]);
      }
    } else if (p + 1 < npass) {
      stage(p + 1);
    }
    __syncthreads();
  }
  if (tid >= 32) {
    for (int r = 0; r < nr; ++r)
      if (cnt[r]) atomicAdd(&s_cnt[r], cnt[r]);
  }
  __syncthreads();
  // 0/0 = NaN for a row with no frame of c0 >= 0, as in the reference
  if (chain) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int l = cl + c * lpr;
      if (l >= ncep) break;
      const float m = __fdiv_rn(s[c], (float)s_cnt[cr]);
      if (kFused)
        s_mean[cr][l] = m;
      else
        mean[(size_t)(b0 + cr) * ncep + l] = m;
    }
  }
  if (!kFused) return;

  // the padded row: frame 0 before the start, the last staged frame
  // (n - 1, or 0) from nraw on; then the mean off every value
  for (int r = 0; r < nr; ++r) {
    float* xs = sm + r * rstride + ncep * lstride;
    const int last = nraw[r] - 1;
    const int nfill = (kWin + T + kWin - (kWin + nraw[r])) * ncep;
    for (int i = tid; i < kWin * ncep + nfill; i += kFoldThreads) {
      const int j = i < kWin * ncep ? i : (kWin + nraw[r]) * ncep +
                                              (i - kWin * ncep);
      const int l = j % ncep;
      xs[j] = xs[(kWin + (i < kWin * ncep ? 0 : last)) * ncep + l];
    }
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    float* xs = sm + r * rstride + ncep * lstride;
    const int n = (T + 2 * kWin) * ncep;
    int f = tid / ncep, l = tid - f * ncep;
    const int dt = kFoldThreads / ncep, dl = kFoldThreads - dt * ncep;
    for (int i = tid; i < n; i += kFoldThreads) {
      xs[i] = __fsub_rn(xs[i], s_mean[r][l]);
      advance(f, l, dt, dl, ncep);
    }
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r)
    emit(sm + r * rstride + ncep * lstride, T, ncep,
         out + (size_t)(b0 + r) * T * 3 * ncep, tid, kFoldThreads);
}

// Features of a tile of frames of one row (the rows past one pass, and
// every row without CMN): stage the tile and 3 frames each side, then
// (with CMN, after the fold's grid) subtract the row's mean, and write.
template <typename Src>
__global__ void __launch_bounds__(kOutThreads)
feat_out_kernel(Src src, const int32_t* __restrict__ n_frames,
                const float* __restrict__ mean, float* __restrict__ out,
                int T, int ncep, int do_cmn, int tile) {
  extern __shared__ __align__(16) float xs[];   // [tile + 6][ncep]
  __shared__ float s_mean[kMaxNcep];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int nt = min(tile, T - t0);
  // padded row t' (t' in [t0 - 3, t0 + nt + 2]): row 0 before the start,
  // row n-1 at and after n (the frames >= n replicate the last real one)
  const int last = min(max(n_frames[b] - 1, 0), T - 1);
  const Src row = src.row((size_t)b * T * ncep);
  const int nst = (nt + 2 * kWin) * ncep;
  const int dt = kOutThreads / ncep, dl = kOutThreads - dt * ncep;
  int f = threadIdx.x / ncep, l = threadIdx.x - f * ncep;
  for (int i0 = threadIdx.x; i0 < nst; i0 += kUnroll * kOutThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kOutThreads;
      const int r = min(max(t0 + f - kWin, 0), last);
      v[u] = i < nst ? row((size_t)r * ncep + l) : 0.f;
      advance(f, l, dt, dl, ncep);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kOutThreads;
      if (i < nst) xs[i] = v[u];
    }
  }
  if (do_cmn) {
    pdl_wait();                                  // the fold's means
    if ((int)threadIdx.x < ncep)
      s_mean[threadIdx.x] = mean[(size_t)b * ncep + threadIdx.x];
    __syncthreads();
    // each thread its own staged values
    f = threadIdx.x / ncep;
    l = threadIdx.x - f * ncep;
    for (int i = threadIdx.x; i < nst; i += kOutThreads) {
      xs[i] = __fsub_rn(xs[i], s_mean[l]);
      advance(f, l, dt, dl, ncep);
    }
  }
  __syncthreads();
  emit(xs, nt, ncep, out + ((size_t)b * T + t0) * 3 * ncep, threadIdx.x,
       kOutThreads);
}

// tile 0: the fused form (one launch a row of one pass)
struct Layout {
  int rows, pass, tile, launches;
};

// The fold's dynamic shared memory: per row, a pass dimension-major (two
// buffers where the row takes several passes) or, fused, one pass and
// the padded row frame-major.
size_t fold_smem(int rows, int pass, bool fused, int T, int ncep) {
  const size_t tr = (size_t)ncep * (pass + 4);
  if (fused)
    return sizeof(float) * rows *
           (tr + ((size_t)(T + 2 * kWin) * ncep + 3) / 4 * 4);
  return sizeof(float) * (T > pass ? 2 : 1) * rows * tr;
}

// The launcher's layout, or (rows, pass, tile) where forced (0: its
// choice; a forced tile takes the two-launch form for any rows).  Where
// its choice would pass the device's shared memory a block, it takes
// one row a block, then the two-launch form, then shorter passes.
// cudaErrorInvalidValue where the layout cannot run: ncep outside
// [1, 128], two rows a fold block past 16 dimensions, a pass not a
// positive multiple of 32, a tile outside [1, 256], more than 65,535
// rows, a fold past the device's shared memory.
cudaError_t choose(int B, int T, int ncep, int do_cmn, int rows, int pass,
                   int tile, Layout* lay) {
  if (ncep < 1 || ncep > kMaxNcep || B > 65535 || rows < 0 || pass < 0 ||
      tile < 0)
    return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = sst_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (e == cudaSuccess)
    e = sst_device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  // every instance declares the same static shared memory
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, feat_fold_kernel<Cep, 1, true, 1>);
  if (e != cudaSuccess) return e;
  const size_t limit = (size_t)optin - fa.sharedSizeBytes;
  const bool auto_rows = rows == 0, auto_pass = pass == 0;
  // measured on the batch rows (PERF.md §6): two rows a fold block
  // once there are more rows than SMs; the one-launch form from 32 rows,
  // below which two launches spread the output over more SMs
  if (auto_rows) rows = (B > sms && T <= kPassMax && ncep <= 16) ? 2 : 1;
  if (auto_pass) pass = std::min((T + 31) / 32 * 32, kPassMax);
  bool fused = do_cmn && tile == 0 && T <= pass && B >= kFusedRows;
  if (fused && auto_rows && fold_smem(rows, pass, true, T, ncep) > limit)
    rows = 1;
  if (fused && fold_smem(rows, pass, true, T, ncep) > limit) fused = false;
  // 64-frame tiles, 32 where those would not give two blocks an SM
  if (tile == 0 && !fused)
    tile = (long long)B * ((T + 63) / 64) < 2LL * sms ? 32 : 64;
  while (!fused && auto_pass && pass > 32 &&
         fold_smem(rows, pass, false, T, ncep) > limit)
    pass -= 32;
  if (rows < 1 || rows > kMaxRows || (rows == 2 && ncep > 16))
    return cudaErrorInvalidValue;
  if (pass < 32 || pass % 32 != 0 || tile > kMaxTile)
    return cudaErrorInvalidValue;
  if (do_cmn && fold_smem(rows, pass, fused, T, ncep) > limit)
    return cudaErrorInvalidValue;
  *lay = Layout{rows, pass, tile, fused || !do_cmn ? 1 : 2};
  return cudaSuccess;
}

template <typename Src, int V, bool kFused, int C>
cudaError_t launch_fold(const Layout& lay, Src src, const int32_t* n_frames,
                        float* mean, float* out, int B, int T, int ncep,
                        cudaStream_t stream) {
  const size_t smem = fold_smem(lay.rows, lay.pass, kFused, T, ncep);
  cudaError_t e = cudaFuncSetAttribute(
      feat_fold_kernel<Src, V, kFused, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  feat_fold_kernel<Src, V, kFused, C>
      <<<(B + lay.rows - 1) / lay.rows, kFoldThreads, smem, stream>>>(
          src, n_frames, mean, out, B, T, ncep, lay.rows, lay.pass);
  return cudaGetLastError();
}

template <typename Src, int V, bool kFused>
cudaError_t launch_fold_c(const Layout& lay, Src src,
                          const int32_t* n_frames, float* mean, float* out,
                          int B, int T, int ncep, cudaStream_t stream) {
  return ncep <= 32 ? launch_fold<Src, V, kFused, 1>(
                          lay, src, n_frames, mean, out, B, T, ncep, stream)
                    : launch_fold<Src, V, kFused, kChains>(
                          lay, src, n_frames, mean, out, B, T, ncep, stream);
}

// V = 4: every row starts on a 16-byte boundary of the source (T * ncep
// a multiple of 4 and the pointer aligned), so four values load at once
template <typename Src, bool kFused>
cudaError_t launch_fold_v(const Layout& lay, Src src, bool vec,
                          const int32_t* n_frames, float* mean, float* out,
                          int B, int T, int ncep, cudaStream_t stream) {
  return vec ? launch_fold_c<Src, 4, kFused>(lay, src, n_frames, mean, out,
                                             B, T, ncep, stream)
             : launch_fold_c<Src, 1, kFused>(lay, src, n_frames, mean, out,
                                             B, T, ncep, stream);
}

template <typename Src>
cudaError_t launch(Src src, bool aligned, const int32_t* n_frames,
                   float* mean, float* out, int B, int T, int ncep,
                   int do_cmn, int rows, int pass, int tile,
                   cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  Layout lay;
  cudaError_t e = choose(B, T, ncep, do_cmn, rows, pass, tile, &lay);
  if (e != cudaSuccess) return e;
  const bool vec = aligned && ((size_t)T * ncep) % 4 == 0;
  if (lay.tile == 0)
    return launch_fold_v<Src, true>(lay, src, vec, n_frames, mean, out, B,
                                    T, ncep, stream);
  if (do_cmn) {
    e = launch_fold_v<Src, false>(lay, src, vec, n_frames, mean, out, B, T,
                                  ncep, stream);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = sizeof(float) * (size_t)(lay.tile + 2 * kWin) * ncep;
  e = cudaFuncSetAttribute(feat_out_kernel<Src>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + lay.tile - 1) / lay.tile, B, 1);
  cfg.blockDim = dim3(kOutThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = do_cmn ? 1 : 0;    // a dependent of the fold
  e = cudaLaunchKernelEx(&cfg, feat_out_kernel<Src>, src, n_frames,
                         (const float*)mean, out, T, ncep, do_cmn, lay.tile);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" int sst_feat(const uint8_t* planes, const int32_t* n_frames,
                        float* mean, float* out, int B, int T, int ncep,
                        float inv_scale, int do_cmn, int rows, int pass,
                        int tile, cudaStream_t stream) {
  const size_t plane = (size_t)B * T * ncep;
  return (int)launch(Planes{planes, planes + plane, inv_scale},
                     ((uintptr_t)planes & 3) == 0, n_frames, mean, out, B, T,
                     ncep, do_cmn, rows, pass, tile, stream);
}

extern "C" int sst_feat_f32(const float* cep, const int32_t* n_frames,
                            float* mean, float* out, int B, int T, int ncep,
                            int do_cmn, int rows, int pass, int tile,
                            cudaStream_t stream) {
  return (int)launch(Cep{cep}, ((uintptr_t)cep & 15) == 0, n_frames, mean,
                     out, B, T, ncep, do_cmn, rows, pass, tile, stream);
}

extern "C" int sst_feat_layout(int B, int T, int ncep, int do_cmn, int rows,
                               int pass, int tile, int32_t* layout) {
  Layout lay;
  const cudaError_t e = choose(B, T, ncep, do_cmn, rows, pass, tile, &lay);
  if (e != cudaSuccess) return (int)e;
  layout[0] = lay.rows;
  layout[1] = lay.pass;
  layout[2] = lay.tile;
  layout[3] = lay.launches;
  return (int)cudaSuccess;
}

extern "C" const char* sst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
