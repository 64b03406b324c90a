// The dense8 megakernels (#1, #2) on bf16 operands (v and the hoisted p;
// Config.matmul_dtype = "bfloat16"): the library dense8_sweep_solve_bf16,
// built apart so that a float32 run never compiles these instances.  The
// kernels, their design and the entry point's contract:
// dense8_sweep_solve.cuh.

#include "dense8_sweep_solve.cuh"

extern "C" int bpmf_dense8_sweep_solve_bf16(BPMF_SWEEP_SOLVE_PARAMS) {
  return sweep_solve_entry<__nv_bfloat16>(BPMF_SWEEP_SOLVE_ARGS);
}
