// Code staging shared by the dense8 kernels for Hopper: the megakernel
// (dense8_sweep_solve.cuh, #1/#2) and the float32 Gram of the split
// pipeline (dense8_gram_rhs.cuh, #3/#4).  A block of kItemsPerBlock items
// (a warp each) walks the frozen axis in tiles of kTile entries; each
// tile of the block's codes is copied to shared memory with cp.async
// while the previous one is compacted and summed.  Beside it, the operand
// types the megakernel reads v and the hoisted p in: float, or
// __nv_bfloat16 for bf16 matmul inputs (Config.matmul_dtype), whose
// 4-entry pieces are 8 bytes.  The tensor-core Gram of bf16 operands
// (dense8_gram_mma.cu) takes cp_async and mul_bf16x2 from here.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bpmf {

constexpr int kItemsPerBlock = 8;   // one warp per item
constexpr int kStageThreads = kItemsPerBlock * 32;
constexpr int kTile = 512;          // frozen entries staged per step
constexpr unsigned kFull = 0xffffffffu;

// An asynchronous copy of N (8 or 16) bytes from global to shared memory.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the block's codes of frozen entries n0 .. n0 + kTile into dst, by
// the block's kStageThreads threads: [item][entry] when the items are code
// rows (kTile contiguous codes per item, in 16-byte copies), [entry][item]
// when they are code columns (each frozen row holds the block's 8 codes:
// one 8-byte copy of int8, one 16-byte copy of int16).  The code array's
// base is 16-byte aligned and n_cols a multiple of kItemsPerBlock.
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* codes, int rows,
                                           int n_cols, int item0, int n0) {
  if (rows) {
    constexpr int kPer16 = 16 / (int)sizeof(T);  // codes per 16-byte copy
    constexpr int kVecPerRow = kTile / kPer16;
    for (int q = threadIdx.x; q < kItemsPerBlock * kVecPerRow; q += kStageThreads) {
      const int it = q / kVecPerRow, c = q % kVecPerRow;
      cp_async<16>(dst + it * kTile + c * kPer16,
                   codes + (size_t)(item0 + it) * n_cols + n0 + c * kPer16);
    }
  } else {
    constexpr int kRowBytes = kItemsPerBlock * (int)sizeof(T);
    for (int n = threadIdx.x; n < kTile; n += kStageThreads)
      cp_async<kRowBytes>(dst + n * kItemsPerBlock,
                          codes + (size_t)(n0 + n) * n_cols + item0);
  }
}

// -- operands: float or bf16 ----------------------------------------------

template <typename V>
constexpr bool kBf16 = sizeof(V) == 2;

// Bytes of a piece of 4 entries of a row of v or p: the unit of every
// vector load and cp.async copy of an operand.
template <typename V>
constexpr int kPieceBytes = 4 * (int)sizeof(V);

// Four bf16 entries (8 bytes, entry 0 in the low half of x) as floats:
// exact, a bf16 is the high half of the float it rounds.
__device__ __forceinline__ float4 unpack4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Entries 0..3 from p (shared or global memory, p on a piece boundary).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return unpack4(*reinterpret_cast<const uint2*>(p));
}

// The same through the read-only cache (global memory only).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return unpack4(__ldg(reinterpret_cast<const uint2*>(p)));
}
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The Gram's products, four at a time: x (a row's entry) times the piece
// of 4 entries loaded by load_piece, added to acc[0..3] in f32.  f32: four
// FMAs.  bf16: each product of two bf16 values rounded to bf16 (ties to
// even), as the TPU kernel's p = pa * pb in bf16 before its f32-accumulated
// matmul, two at a time by one packed multiply (the f32 product of two
// bf16 values is exact, so mul.rn.bf16x2 rounds it once, as a cvt of the
// f32 product would), then added in f32.  x is taken as gram_x gives it:
// the float, or the bf16 in both halves of a 32-bit word.
__device__ __forceinline__ float4 load_piece(const float* p) { return load4(p); }
__device__ __forceinline__ uint2 load_piece(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ float gram_x(const float* p) { return *p; }
__device__ __forceinline__ unsigned gram_x(const __nv_bfloat16* p) {
  return __byte_perm(*reinterpret_cast<const unsigned short*>(p), 0, 0x1010);
}

// gram_x's value as a float (for the rhs), exact.
__device__ __forceinline__ float x_float(float x) { return x; }
__device__ __forceinline__ float x_float(unsigned x2) { return __uint_as_float(x2 << 16); }

// A piece's four entries, each as gram_x gives it.
__device__ __forceinline__ void piece_xs(float4 q, float* xs) {
  xs[0] = q.x; xs[1] = q.y; xs[2] = q.z; xs[3] = q.w;
}
__device__ __forceinline__ void piece_xs(uint2 q, unsigned* xs) {
  xs[0] = __byte_perm(q.x, 0, 0x1010);
  xs[1] = __byte_perm(q.x, 0, 0x3232);
  xs[2] = __byte_perm(q.y, 0, 0x1010);
  xs[3] = __byte_perm(q.y, 0, 0x3232);
}

__device__ __forceinline__ void gram4(float x, float4 q, float* acc) {
  acc[0] = fmaf(x, q.x, acc[0]);
  acc[1] = fmaf(x, q.y, acc[1]);
  acc[2] = fmaf(x, q.z, acc[2]);
  acc[3] = fmaf(x, q.w, acc[3]);
}

__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void gram4(unsigned x2, uint2 q, float* acc) {
  const unsigned lo = mul_bf16x2(x2, q.x), hi = mul_bf16x2(x2, q.y);
  acc[0] += __uint_as_float(lo << 16);
  acc[1] += __uint_as_float(lo & 0xffff0000u);
  acc[2] += __uint_as_float(hi << 16);
  acc[3] += __uint_as_float(hi & 0xffff0000u);
}

// Code of item `it` of the block at entry q of a staged tile.
template <typename T>
__device__ __forceinline__ T code_at(const T* tile, int rows, int it, int q) {
  return rows ? tile[it * kTile + q] : tile[q * kItemsPerBlock + it];
}

}  // namespace bpmf
