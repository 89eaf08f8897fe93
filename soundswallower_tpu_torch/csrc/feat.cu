// K1 `feat`: wire dequant + batch CMN + 1s_c_d_dd dynamic features.
//
// Replaces the jitted XLA program B1 of the JAX package:
// soundswallower_tpu/fe/feat.py feats_full_utt (with cmn_batch and
// compute_feat_1s_c_d_dd), fed by the byte-plane dequant of
// soundswallower_tpu/aligner.py _feats_chunk_planes.feat_one, or (the
// f32 form, sst_feat_f32) by the device front end's float32 cepstra, as
// in _feats_chunk_raw.fe_one.
//
// Bound: bytes.  Per utterance row it reads 2*T*ncep bytes and writes
// 12*T*ncep; the arithmetic is a handful of float32 subtractions per
// output.  The CMN sum is a sequential float32 fold in frame order (the
// reference's order, cmn.c:159-225), so one thread per cepstral
// dimension walks the frames; it is short (T frames of one row) and
// the rows run in parallel, one block each.  Every float op is an
// explicit round-to-nearest intrinsic: the output is bit-equal to the
// JAX program's.
#include "sst_kernels.h"

namespace {

// The row's cepstral value i: dequantized from the byte planes, or read
// from float32 cepstra.
struct Planes {
  const uint8_t* lo;
  const uint8_t* hi;
  float inv_scale;
  __device__ __forceinline__ float operator()(size_t i) const {
    // (int8(hi) << 8 | lo): the low byte of hi*256 is zero, so | == +
    int v = (int)(int8_t)hi[i] * 256 + (int)lo[i];
    return __fmul_rn((float)v, inv_scale);
  }
};

struct Cep {
  const float* c;
  __device__ __forceinline__ float operator()(size_t i) const { return c[i]; }
};

template <typename Load>
__device__ void feat_row(Load load, int n, float* __restrict__ out, int b,
                         int T, int ncep, int do_cmn) {
  extern __shared__ float mean[];  // [ncep]

  if ((int)threadIdx.x < ncep) {
    const int l = threadIdx.x;
    float m = 0.0f;
    if (do_cmn) {
      // frames t < n with c0 >= 0, summed in frame order
      float s = 0.0f;
      int cnt = 0;
      for (int t = 0; t < n && t < T; ++t) {
        if (load((size_t)t * ncep) >= 0.0f) {
          s = __fadd_rn(s, load((size_t)t * ncep + l));
          ++cnt;
        }
      }
      m = __fdiv_rn(s, (float)cnt);  // 0/0 = NaN, as in the reference
    }
    mean[l] = m;
  }
  __syncthreads();

  // padded row t' (t' in [-3, T+2]): row 0 before the start, row n-1 at
  // and after n (the frames >= n replicate the last real frame)
  const int last = max(n - 1, 0);
  for (int i = threadIdx.x; i < T * ncep; i += blockDim.x) {
    const int t = i / ncep;
    const int l = i - t * ncep;
    float c[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int r = min(max(t + k - 3, 0), last);
      const float v = load((size_t)r * ncep + l);
      c[k] = do_cmn ? __fsub_rn(v, mean[l]) : v;
    }
    float* o = out + ((size_t)b * T + t) * 3 * ncep;
    o[l] = c[3];
    o[ncep + l] = __fsub_rn(c[5], c[1]);
    o[2 * ncep + l] = __fsub_rn(__fsub_rn(c[6], c[2]), __fsub_rn(c[4], c[0]));
  }
}

__global__ void feat_kernel(const uint8_t* __restrict__ planes,
                            const int32_t* __restrict__ n_frames,
                            float* __restrict__ out, int B, int T, int ncep,
                            float inv_scale, int do_cmn) {
  const int b = blockIdx.x;
  const size_t row = (size_t)b * T * ncep;
  feat_row(Planes{planes + row, planes + (size_t)B * T * ncep + row, inv_scale},
           n_frames[b], out, b, T, ncep, do_cmn);
}

__global__ void feat_f32_kernel(const float* __restrict__ cep,
                                const int32_t* __restrict__ n_frames,
                                float* __restrict__ out, int T, int ncep,
                                int do_cmn) {
  const int b = blockIdx.x;
  feat_row(Cep{cep + (size_t)b * T * ncep}, n_frames[b], out, b, T, ncep,
           do_cmn);
}

}  // namespace

extern "C" int sst_feat(const uint8_t* planes, const int32_t* n_frames,
                        float* out, int B, int T, int ncep, float inv_scale,
                        int do_cmn, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  feat_kernel<<<B, 128, ncep * sizeof(float), stream>>>(
      planes, n_frames, out, B, T, ncep, inv_scale, do_cmn);
  return (int)cudaGetLastError();
}

extern "C" int sst_feat_f32(const float* cep, const int32_t* n_frames,
                            float* out, int B, int T, int ncep, int do_cmn,
                            cudaStream_t stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  feat_f32_kernel<<<B, 128, ncep * sizeof(float), stream>>>(
      cep, n_frames, out, T, ncep, do_cmn);
  return (int)cudaGetLastError();
}

extern "C" const char* sst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
