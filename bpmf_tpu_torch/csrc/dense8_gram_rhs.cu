// The dense8 Gram and rhs of the split pipeline (#3, #4) on float32
// operands: the library dense8_gram_rhs, loaded by ops/dense8.py.  The
// kernels, their design and the entry point's contract: dense8_gram_rhs.cuh
// (bf16 operands: dense8_gram_mma.cu).

#include "dense8_gram_rhs.cuh"

extern "C" int bpmf_dense8_gram_rhs(BPMF_GRAM_RHS_PARAMS) {
  return gram_rhs_entry(BPMF_GRAM_RHS_ARGS);
}
