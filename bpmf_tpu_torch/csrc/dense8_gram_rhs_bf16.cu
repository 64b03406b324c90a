// The dense8 Gram and rhs of the split pipeline (#3, #4) on bf16 operands
// (v and the hoisted p; Config.matmul_dtype = "bfloat16"): the library
// dense8_gram_rhs_bf16, built apart so that a float32 run never compiles
// these instances.  The kernels, their design and the entry point's
// contract: dense8_gram_rhs.cuh.

#include "dense8_gram_rhs.cuh"

extern "C" int bpmf_dense8_gram_rhs_bf16(BPMF_GRAM_RHS_PARAMS) {
  return gram_rhs_entry<__nv_bfloat16>(BPMF_GRAM_RHS_ARGS);
}
