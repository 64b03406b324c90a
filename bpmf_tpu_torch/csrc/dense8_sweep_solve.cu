// The dense8 megakernels (#1, #2) on float32 operands: the library
// dense8_sweep_solve, loaded by ops/dense8.py.  The kernels, their design
// and the entry point's contract: dense8_sweep_solve.cuh.

#include "dense8_sweep_solve.cuh"

extern "C" int bpmf_dense8_sweep_solve(BPMF_SWEEP_SOLVE_PARAMS) {
  return sweep_solve_entry<float>(BPMF_SWEEP_SOLVE_ARGS);
}
