// Batched Cholesky + substitutions + draw of full SPD precisions for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bpmf_tpu/ops/pallas_solve.py:89
// _kernel_blast_inplace, launched by chol_solve_sample_pallas_blast (:159):
// the solve of the bucketed and plain dense routes.  For every item b:
//
//   L_b L_b' = A_b,  u_b = L_b' \ (L_b \ rhs_b + noise_b)
//
// A_b is the item-major [B, K, K] precision the port forms (prior already
// combined, diagonal-only already applied); only its lower triangle is
// read.  The TPU kernel first transposes the batch last ([K, K, B] tiles,
// the batch on the 128 lanes) and pads it with identity systems to its
// lane block; neither is needed here: every item's matrix is one
// contiguous run, and the grid covers B exactly.
//
// What bounds it on an H100: by the roofline, the bytes at every K up to
// the gate (the lower triangle, K(K+1)/2 * 4 bytes, read per item against
// about K^3/3 + 2K^2 flops: 5.8 flops per byte at K=32, 18 at K=106, below
// the card's ~20 f32 flops per byte); in practice the factorization's K
// dependent steps, each a shuffle, an rsqrt and a column of FMAs.  Design,
// on the solve of the packed-triangle kernel (tri_combine_solve.cu, #5):
//
// * One warp owns one item, and a block holds 8 items (4 where two blocks
//   of 8 would not fit an SM's shared memory: K past 76).  No block-wide
//   barrier anywhere, so a warp leaves as soon as its item is drawn and a
//   ragged last block costs nothing.
// * Staging: each lane copies its columns of the item's lower triangle,
//   row by row (coalesced, the upper triangle never read), straight into
//   the tight packed layout in its warp's area of shared memory with
//   4-byte cp.async: every copy of the item is in flight at once and no
//   register holds it.  (The 16-byte copies of #5 would need the matrix in
//   shared memory row by row first, twice the space.)
// * K <= 64 (capacities 8, 16, 24, 32, 48, 64): the register solve of
//   warp_chol.cuh (row i on lane i % 32, rsqrt pivots, no divides).
// * K 65-106: the panels of warp_chol.cuh, three rows a lane up to K=96,
//   four past it; the triangle (22.7 KB at K=106) stays in shared memory.
//
// Known limits: lanes past K idle in the register solve (K=33 runs on the
// capacity 48); the panel path issues several times the register path's
// instructions per FMA, and past K=64 shared memory caps an SM at 8 to 16
// items in flight; each warp stages its item and then waits for it, with
// no copy of the next item in flight behind its solve.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_chol.cuh"  // the warp's Cholesky and solves, shared with #5

namespace {

using bpmf::ItemVecs;
using bpmf::kPanel;
using bpmf::lcol_floats;
using bpmf::round4;
using bpmf::tight_off;

constexpr int kMaxK = 106;        // chol_solve_sample_smart's gate
constexpr int kMaxThreads = 256;  // 8 items a block, a warp each
constexpr int kSmemPerSm = 227 * 1024;  // usable shared memory of an SM

struct Args {
  const float* prec;   // [B, K, K]
  const float* rhs;    // [B, K]
  const float* noise;  // [B, K]
  int k, b;
  float* out;          // [B, K]
  int area;            // floats of one warp's work area
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// The lower triangle of the row-major K x K matrix src into w in the tight
// packed layout (entry (i, j), j <= i, at w[tight_off(j, k) + i - j]), by
// the warp: lane l copies columns l, l + 32, ... of every row.
__device__ __forceinline__ void stage_item(const float* src, int k, float* w) {
  const int lane = threadIdx.x & 31;
  int at[4];  // where (0, j) of the lane's columns would lie
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = lane + 32 * c;
    at[c] = tight_off(j, k) - j;
  }
  for (int i = 0; i < k; ++i) {
    const float* row = src + (int64_t)i * k;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (32 * c > i) break;  // the row has no column of this group
      const int j = lane + 32 * c;
      if (j <= i) cp_async4(w + at[c] + i, row + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// KP > 0: the register solve at capacity KP; else R rows a lane.
template <int KP, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
chol_solve_sample_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= a.b) return;
  const int k = a.k;
  float* w = smem + warp * a.area;
  const int64_t at = (int64_t)item * k;
  stage_item(a.prec + at * k, k, w);
  const ItemVecs v{a.rhs + at, 1, a.noise + at, 1, a.out + at};
  if constexpr (KP > 0) {
    bpmf::solve_rows<KP>(w, k, v);
  } else {
    bpmf::solve_panels<R>(w, w + round4(k * (k + 1) / 2), k, v);
  }
}

// The instance of K: the register solve's capacity kp (0: the panels), the
// rows a lane r, the floats of a warp's area and the items a block nw.
struct Instance {
  int kp, r, area, nw;
};

Instance instance_of(int k) {
  const int tv = k * (k + 1) / 2;
  Instance in{0, k <= 96 ? 3 : 4, round4(tv) + kPanel * k, 0};
  static const int kCapacities[] = {8, 16, 24, 32, 48, 64};
  for (int c : kCapacities) {
    if (k <= c) {
      in = {c, (c + 31) / 32, round4(tv) > lcol_floats(c) ? round4(tv) : lcol_floats(c), 0};
      break;
    }
  }
  // 8 items a block while two such blocks fit an SM, else 4
  in.nw = 2 * (4 * 8 * in.area) + 2048 <= kSmemPerSm ? 8 : 4;
  return in;
}

template <int KP, int R>
int launch(Args a, const Instance& in, cudaStream_t s) {
  static int configured = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured != dev) {  // above 48 KB only after the attribute is raised
    err = cudaFuncSetAttribute(chol_solve_sample_kernel<KP, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerSm);
    if (err != cudaSuccess) return (int)err;
    configured = dev;
  }
  a.area = in.area;
  const int grid = (a.b + in.nw - 1) / in.nw;
  chol_solve_sample_kernel<KP, R>
      <<<grid, in.nw * 32, sizeof(float) * in.nw * in.area, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  prec is [B, K, K], rhs, noise
// and out are [B, K], all row-major float32.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int bpmf_chol_solve_sample(const void* prec, const void* rhs,
                                      const void* noise, int k, int b,
                                      void* out, void* stream) {
  if (k < 1 || k > kMaxK || b < 1) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(prec), static_cast<const float*>(rhs),
               static_cast<const float*>(noise), k, b, static_cast<float*>(out), 0};
  const Instance in = instance_of(k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in.kp) {
    case 8: return launch<8, 0>(a, in, s);
    case 16: return launch<16, 0>(a, in, s);
    case 24: return launch<24, 0>(a, in, s);
    case 32: return launch<32, 0>(a, in, s);
    case 48: return launch<48, 0>(a, in, s);
    case 64: return launch<64, 0>(a, in, s);
    default: return in.r == 3 ? launch<0, 3>(a, in, s) : launch<0, 4>(a, in, s);
  }
}

// The instance bpmf_chol_solve_sample launches at K, for the wrapper's
// record: out[0] the register solve's capacity (0: the panels), out[1] the
// rows a lane, out[2] the items a block.  Returns 0, or cudaErrorInvalidValue
// for a K past the gate.
extern "C" int bpmf_chol_solve_instance(int k, int* out) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const Instance in = instance_of(k);
  out[0] = in.kp;
  out[1] = in.r;
  out[2] = in.nw;
  return 0;
}
