// Tensor-core building blocks of the dense8 kernels on bf16 operands for
// Hopper (sm_90a), shared by the split pipeline's Gram (dense8_gram_mma.cu,
// #3/#4) and the megakernel (dense8_sweep_solve_mma.cu, #1/#2): wgmma with
// A in registers and B in shared memory, the conversion of the int8/int16
// code tiles into A (the indicator or the values, bf16), and the two
// layouts B takes in shared memory.
//
// * A: mma.m16n8k16's A fragment, a warp's 16 rows of a warpgroup's 64,
//   loaded from the codes as they lie in shared memory (CodeTile) by
//   ldmatrix and turned into bf16 (load_a_codes); with int8 codes the pairs
//   ldmatrix gives are the mma's only up to a permutation (halves_of),
//   which B or the epilogue follow.
// * B K-major, formed by the threads (formed_offset): core matrices of 8
//   columns x 8 entries (16 bytes a column), the 8 along K of a group of 8
//   columns in one run of kGroup bytes.  Descriptor: b_desc(start, kCore,
//   kGroup, 0).
// * B N-major with the 128-byte swizzle, copied from a row-major [N, T]
//   operand (p_offset): atoms of 8 entries x 64 columns (1 KB, 1 KB
//   aligned); a row of 64 columns is one 128-byte row of an atom, its
//   16-byte pieces XORed with the row.  Descriptor: b_desc(start, kPHalf,
//   1024, 1).

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;                  // frozen entries a step
constexpr int kCore = 128;                  // a core matrix: 8 x 16 bytes
constexpr int kGroup = kChunk / 8 * kCore;  // 8 formed columns over a chunk
constexpr int kPHalf = kChunk * 64 * 2;     // 64 columns of p over a chunk
constexpr unsigned kOne2 = 0x3f803f80u;     // bf16x2 (1.0, 1.0)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The descriptor of a B operand in shared memory: its start, the byte
// offsets `lbo` and `sbo` (K-major without swizzle: between 8 x 16-byte
// core matrices along K and along N; N-major with the 128-byte swizzle:
// between atoms along N and along K), and the swizzle (0: none, 1: 128 B).
__device__ __forceinline__ uint64_t b_desc(const void* p, unsigned lbo, unsigned sbo,
                                           unsigned swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3ffffu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)swizzle << 62;
}

// d = a b + (scale_d ? d : 0) on the warpgroup: 64 rows (a: this warp's
// 16, as mma.m16n8k16's A fragment) x 64 columns x 16 of K, bf16 operands,
// float32 sums; B K-major (kTransB = 0) or N-major (1).  Asynchronous: d
// and a stay untouched until wgmma_wait.
template <int kTransB>
__device__ __forceinline__ void wgmma64(float (&d)[32], const unsigned (&a)[4], uint64_t b,
                                        int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers an asynchronous wgmma reads or writes: the compiler keeps them
// in place up to here
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void hold(unsigned& x) { asm volatile("" : "+r"(x)::"memory"); }

// The shared-memory writes of this thread (st.shared, cp.async) made
// visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two 16-bit codes (the halves of x, signed) as bf16x2: their indicator
// (1.0 where not zero), or with `values` their values (exact up to 256).
__device__ __forceinline__ unsigned bf16x2_of_codes(unsigned x, bool values) {
  if (!values) return __vminu2(x, 0x00010001u) * 0x3f80u;
  const __nv_bfloat162 h =
      __floats2bfloat162_rn((float)(int16_t)(x & 0xffffu), (float)(int16_t)(x >> 16));
  unsigned u;
  memcpy(&u, &h, 4);
  return u;
}

// Two bytes of x, sign-extended to the halves of a word (prmt's sign
// mode, which __byte_perm does not take): bytes 0, 1 (kLo01), 2, 3
// (kHi23), 0, 2 (kEven) or 1, 3 (kOdd)
constexpr unsigned kLo01 = 0x9180u, kHi23 = 0xb3a2u, kEven = 0xa280u, kOdd = 0xb391u;

__device__ __forceinline__ unsigned halves_of(unsigned x, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(d) : "r"(x), "r"(sel));
  return d;
}

// A stage of a block's codes as they lie, 128 items (two warpgroups' 64
// rows) x a chunk: [item][entry] (rows) or [entry][item] (cols), each row
// padded by 16 bytes so that ldmatrix's eight rows miss each other's banks.
constexpr int kTileItems = 128;
template <typename T, bool kRows>
struct CodeTile {
  static constexpr int kRowBytes = (kRows ? kChunk : kTileItems) * (int)sizeof(T) + 16;
  static constexpr int kRowsOf = kRows ? kTileItems : kChunk;
  static constexpr int kBytes = kRowsOf * kRowBytes;
};

// A: the 16 rows m0 .. m0 + 15 of a chunk's codes in stage `ctile`, 4
// k-steps of 16 as bf16 (mma.m16n8k16's A fragment, this lane's part): the
// indicator, or with `values` the codes' values.  With int8 codes the pairs
// ldmatrix gives are not the mma's: in the rows orientation a lane holds 4
// consecutive entries of one item (the products' k order permuted within
// each 16: perm_k), in the cols one 2 items x 2 entries (the rows are the
// items in pairs).
template <typename T, bool kRows>
__device__ __forceinline__ void load_a_codes(unsigned (&af)[kChunk / 16][4],
                                       const unsigned char* ctile, int m0, int lane,
                                       bool values) {
  using C = CodeTile<T, kRows>;
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    unsigned r[4];
    if constexpr (sizeof(T) == 1) {
      if constexpr (kRows)  // mats: rows 0-7 / 8-15 x bytes 0-15, then 16-31
        ldsm_x4(r, ctile + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::kRowBytes +
                       32 * (ks / 2) + 16 * (lane >> 4));
      else  // mats: entries 0-7, 8-15, 16-23, 24-31 x items m0 .. m0 + 15
        ldsm_x4_trans(r, ctile + (32 * (ks / 2) + lane) * C::kRowBytes + m0);
      // rows: u item g, entries 4tg..4tg+3, v item g + 8; cols: u entries
      // 2tg, +1 of items 2g, 2g+1, v entries + 8
      const unsigned u = r[2 * (ks % 2)], v = r[2 * (ks % 2) + 1];
      r[0] = kRows ? halves_of(u, kLo01) : halves_of(u, kEven);
      r[1] = kRows ? halves_of(v, kLo01) : halves_of(u, kOdd);
      r[2] = kRows ? halves_of(u, kHi23) : halves_of(v, kEven);
      r[3] = kRows ? halves_of(v, kHi23) : halves_of(v, kOdd);
    } else {
      if constexpr (kRows)  // mats: rows 0-7, 8-15 x entries 0-7, then 8-15
        ldsm_x4(r, ctile + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::kRowBytes +
                       2 * (16 * ks + 8 * (lane >> 4)));
      else  // mats: entries 0-7 x items 0-7, 8-15; entries 8-15 x the same
        ldsm_x4_trans(r, ctile + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * C::kRowBytes +
                             2 * (m0 + 8 * ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) af[ks][q] = bf16x2_of_codes(r[q], values);
  }
}

// Byte offset of entry (k, column n) in a formed B^T tile: K-major core
// matrices of 8 columns x 8 entries (16 bytes a column), the 8 along K of
// a group of 8 columns in a run.
__device__ __forceinline__ int formed_offset(int k, int n) {
  return (n >> 3) * kGroup + (k >> 3) * kCore + (n & 7) * 16 + (k & 7) * 2;
}

// Byte offset of entry (k, column n) in a p tile: N-major with the 128-byte
// swizzle, in atoms of 8 entries x 64 columns (1 KB, 1 KB-aligned), the 8
// along K of a half of 64 columns in a run; in an atom, row k & 7 holds 64
// columns, their 16-byte pieces XORed with the row.  A row of p's 128
// columns is then two whole 128-byte rows of shared memory.
__device__ __forceinline__ int p_offset(int k, int n) {
  return (n >> 6) * kPHalf + (k >> 3) * 1024 + (k & 7) * 128 +
         ((((n >> 3) & 7) ^ (k & 7)) << 4) + (n & 7) * 2;
}

// With int8 codes in the rows orientation the products' k order is
// permuted within each 16 (A's pairs as ldmatrix gives them): the row of a
// chunk that entry r of it goes to in B.
__host__ __device__ __forceinline__ int perm_k(int r) {
  return (r & ~15) | ((r & 2) << 2) | ((r & 12) >> 1) | (r & 1);
}

// x rounded to the nearest bf16 (ties to even), as bf16x2 in both halves
inline unsigned bf16x2_of(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return u | (u << 16);
}

}  // namespace
