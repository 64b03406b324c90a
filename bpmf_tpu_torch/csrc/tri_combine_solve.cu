// Fused prior combine + Cholesky + substitutions + draw for Hopper (sm_90a).
//
// Replaces the TPU kernels bpmf_tpu/ops/pallas_solve.py:307 _kernel_tri_fused
// (shared prior) and :375 _kernel_tri_fused_peritem (per-item prior, the
// propagated posterior -l/-m), and their grouped variants :474
// _kernel_tri_fused_grouped and :502 _kernel_tri_fused_peritem_grouped
// (BPMF_TRI_GROUPED=1), all launched by tri_combine_solve_sample (:607).
// For every item b of one side:
//
//   A_b = Lam_b + alpha*G_b
//   L_b L_b' = A_b,  u_b = L_b' \ (L_b \ rhs_b + noise_b)
//
// G_b is read in the tight packed layout the Gram kernel writes (column j
// at row j*k - j(j-1)/2), Lam_b (per-item prior) in pack_prior_tri's
// 8-aligned layout: bottom-padded (column j from row offs[j]) or, with
// `grouped`, top-aligned (column j from row offs[j] + j % 8).  The TPU's
// grouped kernels slice 8-row groups of that layout so that every slab is
// an aligned static slice, and do the same arithmetic on the live elements
// as the others; here the layout changes only the prior's row offsets.
// The TPU pipeline first expands the tight Gram into the aligned layout
// (tri_expand_rows, a copy of every Gram); here the kernel reads the tight
// one and computes the prior's rows itself.
//
// What bounds it on an H100: the factorization, K^3/6 dependent FMAs per
// item (44k at K=64) in K sequential steps; the bytes are small (one
// packed triangle per item, 8.3 KB at K=64).  The TPU kernel puts the
// batch on the 128 lanes and runs the K steps on [K, B] slabs.  Here one
// warp owns one item, with no block-wide barrier inside its factorization
// or solves, and a block holds 8 items (4 where 8 would leave one block an
// SM), two blocks or more an SM:
//
// * Staging, once per block: each item's packed Gram goes to its warp's
//   area of dynamic shared memory, sized to K.  The item-major Gram of the
//   split route (one contiguous run per item) is copied with 16-byte
//   cp.async; a batch-last Gram (fused dense) is read with the block's
//   items side by side, one 32-byte sector per packed row; any other
//   strides are read as they come.  The shared prior is packed into shared
//   memory once per block; for a per-item prior the block computes the
//   aligned row of every packed entry once (a uint16 table) and reads only
//   those rows, batch-last as it lies, so its padding rows (which repeat
//   the (0, 0) entry) are never read.  Then A = prior + alpha*G in place.
// * K <= 64 (instances of capacity 8, 16, 24, 32, 48, 64, runtime K): the
//   register solve of warp_chol.cuh (solve_rows, the megakernel's solve of
//   dense8_sweep_solve.cu), row i on lane i % 32, up to two rows a lane,
//   rsqrt pivots and no divides.
// * K 65-79 (three rows a lane, runtime K): the panels of warp_chol.cuh
//   (solve_panels), the triangle factored in place in the warp's area in
//   panels of 8 columns.
//
// The solve of full precisions (chol_solve_sample.cu, #8) runs the same two
// solvers from the same header.
//
// Known limits: lanes past K idle in the register solve (K=33 runs on the
// capacity 48); the panel path issues several times the register path's
// instructions per FMA; a layout with no fast path (neither item-major
// contiguous nor batch-last) is read element by element.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_chol.cuh"  // the warp's Cholesky and solves, shared with #8

namespace {

using bpmf::ItemVecs;
using bpmf::kPanel;
using bpmf::lcol_floats;
using bpmf::round4;
using bpmf::tight_off;

constexpr int kMaxK = 80;        // the dense8 gate admits K <= 79
constexpr int kMaxThreads = 256;
constexpr int kSmemPerSm = 227 * 1024;  // usable shared memory of an SM

struct Args {
  const float* gram;
  int64_t g_st, g_sb;
  const float* lam;      // [K, K], or unused
  const float* lam_tri;  // [T, B] or null
  int64_t l_st, l_sb;
  int grouped;
  const float* rhs;
  int64_t r_sk, r_sb;
  const float* noise;
  int64_t n_sk, n_sb;
  int k, b;
  float alpha;
  float* out;  // [B, K]
  int area;    // floats of one warp's work area, a multiple of 4
  int fast;    // gram item-major in 16-byte aligned runs: cp.async
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// The block's systems A = prior + alpha*G into the warps' work areas, the
// packed lower triangle of item it at work + it * area.  The only
// block-wide barriers of the kernel.
__device__ void stage(const Args& a, float* work, float* lam_s, uint16_t* arow) {
  const int k = a.k, tv = k * (k + 1) / 2;
  const int nw = blockDim.x >> 5, tid = threadIdx.x;
  const int b0 = blockIdx.x * nw;
  const int nit = min(nw, a.b - b0);
  if (a.fast) {
    const int n4 = round4(tv) / 4;
    for (int q = tid; q < nit * n4; q += blockDim.x) {
      const int it = q / n4, c = q - it * n4;
      cp_async16(work + it * a.area + 4 * c, a.gram + (b0 + it) * a.g_sb + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else if (a.g_sb == 1) {  // batch-last: the block's items side by side
    for (int q = tid; q < tv * nw; q += blockDim.x) {
      const int t = q / nw, it = q - t * nw;
      if (it < nit) work[it * a.area + t] = __ldg(a.gram + t * a.g_st + b0 + it);
    }
  } else {
    for (int q = tid; q < nit * tv; q += blockDim.x) {
      const int it = q / tv, t = q - it * tv;
      work[it * a.area + t] = __ldg(a.gram + t * a.g_st + (b0 + it) * a.g_sb);
    }
  }
  // the prior: packed (shared, read coalesced), or the aligned row of
  // each packed entry (per item; tri_offsets, top-aligned when grouped)
  if (a.lam_tri) {
    for (int j = tid; j < k; j += blockDim.x) {
      int off = a.grouped ? j % 8 : 0;
      for (int c = 0; c < j; ++c) off += (k - c + 7) / 8 * 8;
      const int t0 = tight_off(j, k);
      for (int i = j; i < k; ++i) arow[t0 + i - j] = (uint16_t)(off + i - j);
    }
  } else {
    for (int q = tid; q < k * k; q += blockDim.x) {
      const int i = q / k, j = q - i * k;
      if (i >= j) lam_s[tight_off(j, k) + i - j] = __ldg(a.lam + q);
    }
  }
  if (a.fast) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (a.lam_tri && a.l_sb == 1) {  // batch-last, as pack_prior_tri lays it
    for (int q = tid; q < tv * nw; q += blockDim.x) {
      const int t = q / nw, it = q - t * nw;
      if (it < nit) {
        float* e = work + it * a.area + t;
        *e = fmaf(a.alpha, *e, __ldg(a.lam_tri + arow[t] * a.l_st + b0 + it));
      }
    }
  } else {
    for (int q = tid; q < nit * tv; q += blockDim.x) {
      const int it = q / tv, t = q - it * tv;
      float* e = work + it * a.area + t;
      const float base = a.lam_tri
          ? __ldg(a.lam_tri + arow[t] * a.l_st + (b0 + it) * a.l_sb)
          : lam_s[t];
      *e = fmaf(a.alpha, *e, base);
    }
  }
  __syncthreads();
}


// KP > 0: the register solve at capacity KP; else R rows a lane.
template <int KP, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
tri_combine_solve_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  float* tables = smem + nw * a.area;  // the packed shared prior, or arow
  stage(a, smem, tables, reinterpret_cast<uint16_t*>(tables));
  const int item = blockIdx.x * nw + warp;
  if (item >= a.b) return;
  float* w = smem + warp * a.area;
  const ItemVecs v{a.rhs + item * a.r_sb, a.r_sk, a.noise + item * a.n_sb, a.n_sk,
                   a.out + (int64_t)item * a.k};
  if constexpr (KP > 0) {
    bpmf::solve_rows<KP>(w, a.k, v);
  } else {
    bpmf::solve_panels<R>(w, w + round4(a.k * (a.k + 1) / 2), a.k, v);
  }
}

template <int KP, int R>
int launch(Args a, cudaStream_t s) {
  const int tv = a.k * (a.k + 1) / 2;
  a.area = KP > 0 ? (round4(tv) > lcol_floats(KP) ? round4(tv) : lcol_floats(KP))
                  : round4(tv) + kPanel * a.k;
  // 8 items a block, or 4 where 8 would leave room for one block per SM
  auto bytes = [&](int nw) { return 4 * ((size_t)nw * a.area + round4(tv)); };
  const int nw = 2 * bytes(8) + 2048 <= (size_t)kSmemPerSm ? 8 : 4;
  static int configured = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured != dev) {
    err = cudaFuncSetAttribute(tri_combine_solve_kernel<KP, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerSm);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tri_combine_solve_kernel<KP, R>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = dev;
  }
  const int grid = (a.b + nw - 1) / nw;
  tri_combine_solve_kernel<KP, R><<<grid, nw * 32, bytes(nw), s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Strides are in elements: entry
// (t, b) of gram (tight layout) is gram[t*g_st + b*g_sb].  lam_tri == null
// selects the shared prior lam ([K, K], row-major); else lam_tri is the
// aligned per-item prior, top-aligned when grouped != 0 (K % 8 == 0).  out
// is [B, K] row-major.  Any strides; item-major Grams in runs of 16-byte
// aligned rows and batch-last ones are read fastest.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int bpmf_tri_combine_solve(
    const void* gram, int64_t g_st, int64_t g_sb, const void* lam,
    const void* lam_tri, int64_t l_st, int64_t l_sb, int grouped,
    const void* rhs, int64_t r_sk, int64_t r_sb, const void* noise, int64_t n_sk, int64_t n_sb,
    int k, int b, float alpha, void* out, void* stream) {
  if (k < 1 || k >= kMaxK || b < 1 || (grouped && k % 8))
    return (int)cudaErrorInvalidValue;
  const int tv = k * (k + 1) / 2;
  Args a{static_cast<const float*>(gram), g_st, g_sb,
         static_cast<const float*>(lam), static_cast<const float*>(lam_tri),
         l_st, l_sb, grouped, static_cast<const float*>(rhs), r_sk, r_sb,
         static_cast<const float*>(noise), n_sk, n_sb, k, b, alpha,
         static_cast<float*>(out), 0, 0};
  a.fast = g_st == 1 && g_sb % 4 == 0 && g_sb >= round4(tv) &&
           reinterpret_cast<uintptr_t>(gram) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch<8, 0>(a, s);
  if (k <= 16) return launch<16, 0>(a, s);
  if (k <= 24) return launch<24, 0>(a, s);
  if (k <= 32) return launch<32, 0>(a, s);
  if (k <= 48) return launch<48, 0>(a, s);
  if (k <= 64) return launch<64, 0>(a, s);
  return launch<0, 3>(a, s);
}
