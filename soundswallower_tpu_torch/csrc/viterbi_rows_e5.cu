// K6 in its 5-state forms: viterbi_rows.cu compiled with SST_VIT_E5
// (entry point sst_viterbi_rows_e5, called by sst_viterbi_rows for
// E = 5), so that the two build in parallel.
#define SST_VIT_E5
#include "viterbi_rows.cu"
