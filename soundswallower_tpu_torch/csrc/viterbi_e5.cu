// K4 and its carry form in their 5-state forms: viterbi.cu compiled with
// SST_VIT_E5 (entry points sst_viterbi_batch_e5 and sst_viterbi_chunk_e5,
// called by viterbi.cu's for E = 5), so that the two build in parallel.
#define SST_VIT_E5
#include "viterbi.cu"
