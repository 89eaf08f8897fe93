// C interface of the aligner's CUDA kernels (loaded with ctypes by
// soundswallower_tpu_torch/utils/cuda_build.py).
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t,
// launches on that stream without synchronising, allocates nothing,
// and returns cudaGetLastError() of its launch.  Shapes are runtime
// arguments: a new transcript, batch size, used-codebook count or
// frame count never costs a build.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SST_WORST_SCORE (-0x20000000)
#define SST_TMAT_WORST (-255)
#define SST_SENSCR_SHIFT 10
#define SST_MAX_NEG_ASCR 96
#define SST_MAX_TOPN 8
#define SST_MAX_DENSITIES 128

extern "C" {

// K1: wire dequant + batch CMN + 1s_c_d_dd dynamic features.
// planes uint8 [2, B, T, ncep] (plane 0 = low byte), n_frames int32 [B]
// -> out float32 [B, T, 3, ncep]; mean float32 [B, ncep] is scratch (the
// CMN means; unused without do_cmn).  rows (fold rows a block, 1 or 2),
// pass (frames a fold pass, a multiple of 32) and tile (output frames a
// block, 1-256): 0 for the launcher's choice (sst_feat_layout).  One
// launch for rows of one pass with CMN (the fold block writes its rows'
// features); two for longer rows or a forced tile (the fold, then the
// tiled output as its programmatic dependent); one without CMN (tiled).
int sst_feat(const uint8_t* planes, const int32_t* n_frames, float* mean,
             float* out, int B, int T, int ncep, float inv_scale, int do_cmn,
             int rows, int pass, int tile, cudaStream_t stream);

// K1's layout for B rows of T frames: layout[0..3] = rows a fold block,
// frames a pass, frames a tile (0: the one-launch form), launches;
// (rows, pass, tile) forced where not 0.  cudaErrorInvalidValue for a
// layout the launcher cannot run (a fold past the device's shared memory
// among them).
int sst_feat_layout(int B, int T, int ncep, int do_cmn, int rows, int pass,
                    int tile, int32_t* layout);

// K2: Mahalanobis fold (or, mxu != 0, the expanded distance with the
// per-table muv f32 [Cu, F, D, L] and c f32 [Cu, F, D]) + top-N +
// cross-codebook norm, one block a tile of sst_dist_topn_tile(N, F)
// frames of one stream.
// feats f32 [N, F, L]; means/var_t f32 [Cu, F, D, L]; det f32 [Cu, F, D]
// -> s int32 [N, Cu, F, topn] (normalized, clamped to 96),
//    cw int32 [N, Cu, F, topn] (density indices).
int sst_dist_topn_norm(const float* feats, const float* means,
                       const float* var_t, const float* det, const float* muv,
                       const float* c, int32_t* s, int32_t* cw, int N, int Cu,
                       int F, int D, int L, int topn, int mxu,
                       cudaStream_t stream);

// K2's frame tile for N frames of F streams on the current device (16,
// 32 or 64), -1 where the device cannot be read.
int sst_dist_topn_tile(int N, int F);

// K3: senone evaluation in graph-state order.
// s/cw int32 [N, Cu, F, topn] (cw in [0, D)); mixw uint8 [F, D, S];
// cb_pos int32 [S]; table int32 [table_len] (8-bit log-add table)
// -> out int32 [N, S].  A block takes a range of columns and a tile of
// frames (sst_senone_eval_layout).
int sst_senone_eval(const int32_t* s, const int32_t* cw, const uint8_t* mixw,
                    const int32_t* cb_pos, const int32_t* table,
                    int table_len, int32_t* out, int N, int Cu, int F, int D,
                    int S, int topn, int wrap_u8, cudaStream_t stream);

// K3's layout for N frames of S columns on the current device: layout
// int32 [3] <- the columns a block (128, 64 or 32), its frame tile
// (16-128) and the codebooks it stages a pass.  Returns a cudaError_t.
int sst_senone_eval_layout(int N, int S, int Cu, int F, int topn,
                           int32_t* layout);

// K4: whole-utterance lane Viterbi + final-node select + backtrace.
// sen int32 [B, T, P*E] (E = 3 or 5 emitting states); n_frames int32 [B];
// tp int32 [P, E, E+1]; pred_idx/pred_pen int32 [P, K] with pred_n int32
// [P] real slots a phone, slots 0 .. pred_n-1 (align_torch.pred_count);
// tp_t [E*(E+1), P], pred_idx_t/pred_pen_t [K, P] the same, slot-major;
// astart/aend/entry int32 [P]; fin int32 [n_fin]
// -> tok [B, T, P*E] (scratch), tsc int32 [B, T, P*E] (scratch, NULL
// without scores), path [B, T] (tok and path int16 with tok_bytes 2,
// int32 with 4), pscore int32 [B, T] (NULL without scores), fscore int32
// [B].  gstate: NULL for the Viterbi state in shared memory, else a
// scratch of B * sst_viterbi_state_bytes(P, E) bytes (16-byte aligned).
int sst_viterbi_batch(const int32_t* sen, const int32_t* n_frames,
                      const int32_t* tp, const int32_t* pred_idx,
                      const int32_t* pred_pen, const int32_t* tp_t,
                      const int32_t* pred_idx_t, const int32_t* pred_pen_t,
                      const int32_t* pred_n, const int32_t* astart,
                      const int32_t* aend, const int32_t* entry,
                      const int32_t* fin, int B, int T,
                      int P, int E, int K, int n_fin, void* tok, int tok_bytes,
                      int32_t* tsc, void* path, int32_t* pscore,
                      int32_t* fscore, uint8_t* gstate, cudaStream_t stream);

// Dynamic shared memory the Viterbi kernels need for P phones of E
// states with the state in shared memory.
int sst_viterbi_smem_bytes(int P, int E);

// Bytes of one row's Viterbi state in the global layout.
int64_t sst_viterbi_state_bytes(int P, int E);

// K5: per-row column gather.  src int16 or int32 (elem_bytes 2 or 4)
// [B, T, Sx]; cols int32 [B, S] -> out int32 [B, T, S]; a block a row's
// 8 frames, a thread a column.
int sst_gather_cols(const void* src, int elem_bytes, const int32_t* cols,
                    int32_t* out, int B, int T, int Sx, int S,
                    cudaStream_t stream);

// K5's launch for S columns: layout[0] threads a block (S rounded up to
// a warp, at most 1,024), layout[1] frames a block.
int sst_gather_cols_layout(int S, int32_t* layout);

// K6: per-row-graph lane Viterbi + masked final select + backtrace.
// sen int32 [B, T, P*E]; n_frames int32 [B]; tp int32 [B, P, E, E+1];
// src/pen int32 [B, P, K] each phone's predecessors and penalties in the
// order they are weighed, nin int32 [B, P] how many (the K-slot form's
// pred_idx/pred_pen/pred_n, or the band form's lists,
// align_torch.band_lists); astart/aend/entry int32 [B, P]; final_mask
// uint8 [B, P] -> tok [B, T, P*E] (scratch), tsc int32 [B, T, P*E]
// (scratch, NULL without scores), path [B, T] (tok and path int16 or
// int32 by tok_bytes), pscore int32 [B, T] (NULL without scores), fscore
// int32 [B].  cluster: what sst_viterbi_rows_cluster returned for the
// same P, E, tok_bytes, scores and asked size (> 0: blocks a row, the
// state in shared memory; 0: one block, the state in gstate, a scratch of
// B * sst_viterbi_state_bytes(P, E) bytes, else NULL).
int sst_viterbi_rows(const int32_t* sen, const int32_t* n_frames,
                     const int32_t* tp, const int32_t* src,
                     const int32_t* pen, const int32_t* nin,
                     const int32_t* astart, const int32_t* aend,
                     const int32_t* entry, const uint8_t* final_mask, int B,
                     int T, int P, int E, int K, void* tok, int tok_bytes,
                     int32_t* tsc, void* path, int32_t* pscore,
                     int32_t* fscore, uint8_t* gstate, int cluster,
                     cudaStream_t stream);

// K6's layout for P phones of E states, in *layout: blocks a row (a
// thread-block cluster past 1), 0 for one block with the state in global
// memory, -1 where the asked size cannot run.  cluster 0 asks for the
// smallest of 1, 2, 4, 8 and 16 blocks that holds each thread's phones in
// registers with the prefetch and can be resident; 1 for one block; 2-16
// for a cluster of that size.  Returns the cudaError_t of the occupancy
// query (a fault of the card, never a size that cannot run).
int sst_viterbi_rows_cluster(int P, int E, int tok_bytes, int scores,
                             int cluster, int* layout);

// K7: the dense per-frame tail.  in int32 [N, S] -> out int16 [N, S] =
// int16(in) - int16(min over the frame's S scores) (sub = 1, ptm), or
// int16(in) (sub = 0, semi).
int sst_frame_best_sub(const int32_t* in, int16_t* out, int N, int S,
                       int sub, cudaStream_t stream);

// K1, float32 form: cep float32 [B, T, ncep], n_frames int32 [B]
// -> out float32 [B, T, 3, ncep]; mean, rows, pass and tile as sst_feat's.
int sst_feat_f32(const float* cep, const int32_t* n_frames, float* mean,
                 float* out, int B, int T, int ncep, int do_cmn, int rows,
                 int pass, int tile, cudaStream_t stream);

// K4, carry form (frames t0 .. t0+C-1 of R utterance rows, one block or
// one thread-block cluster a row).  sen int32 [R, C, P*E]; each row's
// frame count n_rows int32 [R] or, n_rows NULL, n for every row; graph
// tables as K4's; carry score/hist int32 [R, P, E], osc/ohi int32 [R, P],
// best_prev int32 [R], read and written back -> tok [R, C, P*E] (int16
// or int32 by tok_bytes).  With fin != NULL (int32 [n_fin]), also the
// final-node select and backtrace: path int32 [R, C] (-1 at and after
// n - t0), fscore int32 [R].  cluster: what sst_viterbi_chunk_cluster
// returned for the same P, E, tok_bytes and asked size (> 0: blocks a
// row, the state in shared memory, anext NULL; 0: one block working on
// the carries in place, anext a uint8 [R, P] scratch).
int sst_viterbi_chunk(const int32_t* sen, int t0, int n,
                      const int32_t* n_rows, const int32_t* tp,
                      const int32_t* pred_idx, const int32_t* pred_pen,
                      const int32_t* tp_t, const int32_t* pred_idx_t,
                      const int32_t* pred_pen_t, const int32_t* pred_n,
                      const int32_t* astart, const int32_t* aend,
                      int32_t* score, int32_t* hist,
                      int32_t* osc, int32_t* ohi, int32_t* best_prev, int R,
                      int C, int P, int E, int K, void* tok, int tok_bytes,
                      const int32_t* fin, int n_fin, int32_t* path,
                      int32_t* fscore, uint8_t* anext, int cluster,
                      cudaStream_t stream);

// The carry form's layout for R rows of P phones of E states, in
// *layout, from K6's plan: blocks a row, 0 for one block with the state
// in global memory, -1 where the asked size cannot run.  cluster 0 asks
// for one block where it holds each thread's phones in registers (P <=
// 2,048), else the smallest cluster whose ranks hold at most 512 phones
// (or 16), or the next smaller that holds the row, of which R can be
// resident at once; 1 for one block; 2-16 for a cluster of that size.
// Returns the cudaError_t of the occupancy query.
int sst_viterbi_chunk_cluster(int P, int E, int tok_bytes, int R,
                              int cluster, int* layout);

// K8: pre-emphasis, framing, the frame mean (remove_dc != 0), window,
// FFT, power spectrum, mel fold; one block a tile of
// sst_fe_spec_frames(...) consecutive frames of one row, a warp a frame.
// sig int16 (sig_i16 = 1) or float32 [B, N]; n_samps int32 [B]; prior
// float32 [B]; window float64 [size]; perm int32 [nfft] the bit reversal
// (the plain version's table; the kernel computes it); ccc/sss float64
// [nfft/4]; spec_start/widths int32 [nfilt]; coeff float32 [nfilt, maxw]
// -> out float64 [B, T, nfilt].
int sst_fe_spec(const void* sig, int sig_i16, const int32_t* n_samps,
                const float* prior, const double* window, const int32_t* perm,
                const double* ccc, const double* sss,
                const int32_t* spec_start, const int32_t* widths,
                const float* coeff, double* out, int B, int N, int T,
                int shift, int size, int nfft, int nfilt, int maxw,
                double alpha, int remove_dc, cudaStream_t stream);

// K8's frames a block for nfft on the current device (1 to 16), 0 where
// one frame's shared memory does not fit, -1 where the device cannot be
// read.
int sst_fe_spec_frames(int shift, int size, int nfft, int nfilt, int maxw);

// K9: noise removal, one block a row in tiles of sst_fe_noise_tile(nf)
// frames.  mfspec float64 [B, T, nf]; n_frames int32 [B] (NULL: T for
// every row); carry power/noise/floor/peak float64 [B, nf] and undef
// uint8 [B], read and written back -> out float64 [B, T, nf].  masked:
// the floor update's operand order of the JAX program's masked scan.
int sst_fe_noise(const double* mfspec, const int32_t* n_frames, double* power,
                 double* noise, double* floor_, double* peak, uint8_t* undef,
                 double* out, int B, int T, int nf, int masked,
                 cudaStream_t stream);

// K9's frame tile for nf filters on the current device (32, halved until
// the block's shared memory fits), -1 where none fits or the device
// cannot be read.
int sst_fe_noise_tile(int nf);

// K10: log, DCT (kind 0 dct, 1 htk, 2 legacy), lifter.  mfspec float64
// [M, nfilt]; mel_cosine float32 [ncep, nfilt]; lifter float32 [ncep] or
// NULL -> either ls_out float64 [M, nfilt] (the log spectra; cep NULL)
// or cep float32 [M, ncep] (ls_out NULL).
int sst_fe_cep(const double* mfspec, const float* mel_cosine,
               const float* lifter, double* ls_out, float* cep, int M,
               int nfilt, int ncep, int kind, float scale0, float sqrt_inv_2n,
               cudaStream_t stream);

// K11: ms fold + float top-N (ties to the later density, the
// WORST_DIST floor) or, with ne == D, every density in index order; one
// block a tile of frames of one stream and a part of the codebooks
// (sst_ms_dist_topn_layout), in the frame form (a thread a frame's top N)
// or the density form (a thread a density).
// feats f32 [N, F, L]; means/var_t f32 [C, F, D, L]; det f32 [C, F, D]
// -> dval f32 [N, C, F, ne], cw int32 [N, C, F, ne].
int sst_ms_dist_topn(const float* feats, const float* means,
                     const float* var_t, const float* det, float* dval,
                     int32_t* cw, int N, int C, int F, int D, int L, int ne,
                     cudaStream_t stream);

// K11 in a forced form (1 the frame form, at L = 39 with ne <= 8 or
// ne == D; 0 the density form's runtime-L form; 13 at L = 13 the density
// form that holds the model rows in registers) and, where parts > 0,
// with the codebooks split into that many parts (0: the launcher's
// choice).
int sst_ms_dist_topn_at(const float* feats, const float* means,
                        const float* var_t, const float* det, float* dval,
                        int32_t* cw, int N, int C, int F, int D, int L,
                        int ne, int form, int parts, cudaStream_t stream);

// K11's launch for N frames, C codebooks, F streams of D densities and
// L dims, top ne: out[0] the frame tile, out[1] the parts the codebooks
// split into, out[2] the form sst_ms_dist_topn takes (1, 13 or 0).
int sst_ms_dist_topn_layout(int N, int C, int F, int D, int L, int ne,
                            int32_t* out);

// K12: ms senone eval, in groups of G senones (a power of two up to
// 128) in codebook order that span at most U codebooks
// (senscore_torch.ms_groups), one block a group and a tile of
// sst_ms_senone_eval_tile frames, then each frame's best subtracted.
// dval f32 / cw int32 [N, C, F, ne]; wts uint8 [S, row] each sorted
// senone's weights [F, D], rows of row bytes (a multiple of 4); order
// int32 [S] the senone at each sorted place; slot int32 [S] (sorted) its
// codebook's place in its group's list gcb int32 [ceil(S / G), U]
// (codebooks, -1 past a group's own); table int32 [table_len] (8-bit
// log-add table, entries in [0, 255]); zero8 the 8-bit logmath zero;
// aw >= 1 -> out int16 [N, S] in senone order, 0 = best per frame;
// fmin int32 [N] scratch (each frame's best).
int sst_ms_senone_eval(const float* dval, const int32_t* cw,
                       const uint8_t* wts, int row, const int32_t* order,
                       const int32_t* slot, const int32_t* gcb, int G, int U,
                       const int32_t* table, int table_len, int16_t* out,
                       int32_t* fmin, int N, int C, int F, int D, int S,
                       int ne, int zero8, int aw, cudaStream_t stream);

// The frame tile K12 takes (0 where one frame's terms do not fit, -1
// where the device cannot be read).
int sst_ms_senone_eval_tile(int N, int S, int G, int U, int F, int ne);

// K13: backtrace over one rank's token chunk.  tok int16 (tok_bytes 2)
// or int32 (4) [R, C, S]; start int32 [R] (the state entering from the
// next chunk); n_frames int32 [R]; chunk frames t0 .. t0+C-1 -> path
// int32 [R, C], out_state int32 [R] (the state leaving the chunk).
// The chunk is walked in K = ceil(C / L) segments of L frames (L >= 1,
// K <= 1024; the wrapper takes sst_backtrace_segment_len(R, C, S,
// tok_bytes)); maps: a scratch of R * K * S int32 (unread, and may be
// NULL, where K = 1).
int sst_backtrace_chunk(const void* tok, int tok_bytes, const int32_t* start,
                        const int32_t* n_frames, int32_t* path,
                        int32_t* out_state, int32_t* maps, int R, int C,
                        int S, int t0, int L, cudaStream_t stream);

// The segment length K13 takes for a chunk of R rows, C frames and S
// states (C: one segment, the one-chain walk).
int sst_backtrace_segment_len(int R, int C, int S, int tok_bytes);

// K14: YIN's float32 CMND and period pick: blocks of tpf threads, R lags
// a thread; one launch where a block holds a whole frame (it also scans,
// writes the CMND and picks), else the differences d(t) of a frame's lag
// tiles into cmnd, then a block a frame scans, writes and picks.
// frames int16 (is_i16 = 1) or float32 [N, F]; lags t < ndiff <= F
// (samples past F - 1 read sample F - 1); thr the float32 threshold on
// the x32768 scale -> cmnd float32 [N, ndiff], period int64 [N], best
// float32 [N].  R (4 or 8) and tpf (64 or 128): 0 for the launcher's
// choice (sst_yin_layout).
int sst_yin_cmnd(const void* frames, int is_i16, float* cmnd,
                 int64_t* period, float* best, int N, int F, int ndiff,
                 float thr, int R, int tpf, cudaStream_t stream);

// K14's layout for N frames of ndiff lags: layout[0..4] = R, threads a
// block, lag tiles a frame, blocks of the first launch, launches (1 or
// 2); (R, tpf) forced where not 0.
int sst_yin_layout(int N, int ndiff, int R, int tpf, int32_t* layout);

const char* sst_error_string(int err);

}  // extern "C"

// An attribute of the current device (its SM count, its shared memory a
// block, ...) into *value.
inline cudaError_t sst_device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaDeviceGetAttribute(value, attr, dev) : err;
}

// Blocks of `kernel` (`threads` a block, no dynamic shared memory) that
// fill every SM of the current device once: the grid of a grid-stride
// kernel.
template <typename Kernel>
inline int sst_fill_blocks(Kernel kernel, int threads) {
  int sms = 0, per_sm = 0;
  sst_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}
