// dense8 Gram and rhs on bf16 operands for Hopper (sm_90a), on the tensor
// cores: the first stage of the split pipeline at Config.matmul_dtype =
// "bfloat16" (the library dense8_gram_mma, loaded by ops/dense8.py).
//
// Replaces, on bf16 operands, the TPU kernels bpmf_tpu/ops/dense8.py:233
// _kernel_inpt (#3: the packed products formed in the kernel, launched at
// :287) and :339 _kernel (#4: the packed products streamed from a hoisted
// operand, launched at :415).  Each is a dense MXU product of a bf16
// operand against the indicator of the code tile, and so is this kernel.
// For the items i of one side (the code rows, or the columns), over every
// frozen entry n, with ind = (code != 0):
//
//   gram[i, t] = sum_n ind[i, n] p[n, t]                          t < T
//   rhs[i, k]  = alpha sum_n code[i, n] wc[n, k] + beta sum_n ind[i, n] wb[n, k]
//
//   #3: p[n, t] = bf16(v[n, ii_t] v[n, jj_t]) in the tight layout, zero
//       past K(K+1)/2; wc = wb = v; alpha = cs, beta = cb (:262-264);
//   #4: p is the caller's [N, T] rows, every one summed (padding too);
//       wc = bf16(bf16(cs) v), wb = bf16(bf16(cb) v); alpha = beta = 1
//       (the default fold, :372-378).
//
// Every product is exact (a {0,1} or an integer code times a bf16 value,
// or two bf16 values) and every sum is float32 in the mma, so the results
// are the JAX package's up to the order of the sums.  Codes are bf16 as on
// the TPU (codes.astype(bf16)): exact up to 256, so for every int16 code
// that build_code_array writes.
//
// What bounds it on an H100, and why it is dense.  At [6144, 4096], K=64,
// 4% rated, the bytes it must move (the codes once, v or p once, the
// outputs once) take 0.042 ms (#3) and 0.054 ms (#4) at 3.35 TB/s.  The
// dense product does items x frozen x (T + 2K) multiply-adds whatever the
// density: 111 GFLOP there, 0.112 ms at the tensor cores' 989 TFLOP/s, so
// its operations bound it, 2-3x above the bytes.  A sparse walk over the
// rated entries (csrc/dense8_gram_rhs.cuh's design, which float32
// operands keep) does only their work, but on the CUDA cores and a rating
// at a time: on bf16 operands on an H100 #3 ran at 3.4 TFLOP/s (1.0M
// ratings x 4160 operations in 1.248 ms, both orientations), #4 at a load
// of a packed row per rating (2.554 ms; PERF.md §6).  At a density d the
// walk takes about d / 4% of that, so the dense form at the tensor cores'
// peak wins above d = 4% x 2 x 0.112 / 1.248 = 0.7% of the padded array,
// and at this kernel's rate (PERF.md) above about 2.6%.
//
// Design: dense over tiles, as the TPU kernel is.
//
// * A block owns 128 items x 128 output columns: two warpgroups of 64
//   items, each with wgmma m64n64k16 on the two halves of the columns (64
//   float32 sums a thread, two blocks an SM).  Column tiles past the
//   Gram's ceil(T / 128) hold the rhs, 64 entries of K a tile: columns
//   0-63 against the codes' values, 64-127 against the indicator, so that
//   a thread holds both sums of an entry and adds them in the epilogue
//   (K <= 64: one tile; 65-79: two).
// * It walks its segment of the frozen axis in chunks of 64, with one
//   barrier a chunk.  The codes and #4's rows of p come by 16-byte
//   cp.async in 4 stages (int16 codes: 3), chunk c multiplied while the
//   next ones fly; v_t's rows in two, chunk c + 2's while chunk c + 1's B
//   is formed.
// * A is in registers (wgmma's register operand, the layout of
//   mma.m16n8k16's A fragment): each warp takes its 16 rows of the codes
//   as they lie in shared memory by ldmatrix (int8 codes two to a 16-bit
//   lane, int16 one) and turns them into bf16: the indicator (1.0/0.0, by
//   an integer min and multiply on 16-bit halves) or the values.  The
//   indicator and the code arrays never exist in device or shared memory,
//   as on the TPU.  With int8 codes the pairs that ldmatrix gives are not
//   the mma's: in the rows orientation a thread holds 4 consecutive frozen
//   entries of one item, so the products' k order is permuted within each
//   16 (kPermK: B follows it, in the formed layout and in the rows a p
//   tile is copied to); in the cols orientation it holds 2 items x 2
//   entries, so the products' rows are the items in pairs (kPairM: the
//   epilogue follows it).
// * B is read by the tensor cores from shared memory.  #4's Gram tiles
//   copy p's 64 rows x 128 columns N-major with the 128-byte swizzle, so a
//   warp copies whole 128-byte runs of p without bank conflicts (in core
//   matrices without swizzle the 16-byte pieces of one row land in one
//   bank).  Every other tile forms B^T K-major from
//   v_t's rows, a thread a column: #3's p[n, t] by mul.rn.bf16x2 two
//   entries at a time (the rounding of the TPU kernel's pa * pb in bf16),
//   the rhs tiles' wc/wb from v and the packed weights; the next chunk's
//   B is formed while the tensor cores multiply this one.
// * The frozen axis splits into S segments where the tiles are too few to
//   fill the card (chembl's 512 proteins over 167k compounds;
//   ops/dense8.mma_plan): each segment writes its partial tile to a
//   scratch [S, items, T + roundup(K, 4)] and counts its arrival on an
//   int32 counter per tile; the last block sums the S partials in segment
//   order 0..S-1 and resets the counter.  No float atomics: repeated
//   launches are bitwise equal.
//
// Known limits: the products alone (no copies, conversion or forming)
// take 0.16-0.19 ms at [6144, 4096] K=64, 60-70% of the tensor cores'
// peak; the copies, the conversion and #3's forming are not all hidden
// behind them (the wgmma of a chunk is waited for before the next one's A
// is converted).  Codes come as cp.async, not TMA; each of the 18-26
// column tiles of an item tile reads its codes from L2 again, and #3
// forms each chunk's products in every item tile's blocks.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense8_mma.cuh"    // wgmma, the code tiles as A, B's layouts
#include "dense8_stage.cuh"  // cp_async, mul_bf16x2

namespace {

using bpmf::cp_async;
using bpmf::cp_async_commit;
using bpmf::cp_async_wait;
using bpmf::mul_bf16x2;

constexpr int kItems = kTileItems;  // items a block: the rows of its mma tiles
constexpr int kCols = 128;     // output columns a block
constexpr int kThreads = 256;  // 2 warpgroups, 64 items each
constexpr int kHalf = 64;      // rhs entries a tile: 64 columns each on the
                               // codes and on the indicator
constexpr int kMaxK = 80;      // the dense8 gate admits K <= 79
constexpr int kBTile = kCols * kChunk * 2;  // a bf16 B tile (formed, or two p halves)
constexpr int kVPitch = kChunk + 8;         // bf16 v_t [k][entry] stage

// Dynamic shared memory, from its first 1 KB boundary: kStages stages of
// codes (4 of int8 codes, 3 of int16, so that two blocks share an SM),
// then either kStages p tiles (#4's Gram tiles) or two formed B^T tiles
// and two stages of v_t's rows (kv = roundup(k, 8) of them).
// ops/dense8.mma_plan computes the same bytes.
template <typename T>
struct MmaSmem {
  static constexpr int kStages = sizeof(T) == 1 ? 4 : 3;
  static constexpr int kStage = CodeTile<T, true>::kBytes > CodeTile<T, false>::kBytes
                                    ? CodeTile<T, true>::kBytes
                                    : CodeTile<T, false>::kBytes;
  static constexpr int kBOff = kStages * kStage;
  __host__ __device__ static constexpr int vt_tile(int kv) { return kv * kVPitch * 2; }
  __host__ __device__ static constexpr int bytes(int kv) {  // + 1 KB to align
    return 1024 + kBOff + (kStages * kBTile > 2 * kBTile + 2 * vt_tile(kv)
                               ? kStages * kBTile
                               : 2 * kBTile + 2 * vt_tile(kv));
  }
  static_assert(kBOff % 1024 == 0, "B tiles on 1 KB boundaries (the swizzle's atoms)");
};

struct MmaArgs {
  const unsigned char* codes;
  int n_cols;              // the code array's row pitch, in codes
  int items, n_frozen, k, kv, t_out;
  int pw;                  // floats of an item's partial: t_out + roundup(k, 4)
  const uint16_t* vt;      // v_t [k, n_frozen] bf16
  const uint16_t* p;       // #4: [n_frozen, t_out] bf16; #3: null
  float alpha, beta;       // rhs = alpha (codes half) + beta (indicator half)
  unsigned w_code, w_ind;  // bf16x2 weights of v on the rhs tile's halves
  int gram_tiles, n_chunks, chunks_per_seg;
  float* partial;          // [S, items, pw] when S > 1
  int* arrivals;           // [item tiles x column tiles], zero between launches
  float* gram;             // [items, t_out]
  float* rhs;              // [items, k]
};

// Copy chunk c's codes into code stage s3, and on #4's Gram tiles (from_p)
// its rows of p into p stage s3.
template <typename T, bool kRows, bool kPermK>
__device__ __forceinline__ void issue_chunk(const MmaArgs& a, unsigned char* smem,
                                            int item0, int col0, bool from_p, int c,
                                            int s3) {
  using L = MmaSmem<T>;
  using C = CodeTile<T, kRows>;
  const int tid = threadIdx.x;
  const int n0 = c * kChunk;
  constexpr int kPieces = C::kRowBytes / 16 - 1;  // 16-byte copies a row
  unsigned char* dst = smem + s3 * L::kStage;
  for (int q = tid; q < (kRows ? kItems : kChunk) * kPieces; q += kThreads) {
    const int r = q / kPieces, off = 16 * (q - r * kPieces);
    const size_t at = kRows ? (size_t)(item0 + r) * a.n_cols + n0
                            : (size_t)(n0 + r) * a.n_cols + item0;
    cp_async<16>(dst + r * C::kRowBytes + off, a.codes + at * sizeof(T) + off);
  }
  if (!from_p) return;
  // the rows of p, swizzled (p_offset), a warp on 4 rows: 128-byte runs of
  // p into whole rows of an atom; with kPermK row 4q + 2h + e of each 16
  // goes to position 8h + 2q + e (the mma's k order)
  unsigned char* pd = smem + L::kBOff + s3 * kBTile;
  const int lg = a.t_out % 8 == 0 ? 4 : 5;  // log2 copies a row: p's rows are
  const int vec = kCols >> lg;              // 16- or 8-byte aligned
  for (int q = tid; q < kChunk << lg; q += kThreads) {
    const int r = q >> lg, col = vec * (q & ((1 << lg) - 1));
    if (col0 + col >= a.t_out) continue;
    const int sr = kPermK ? perm_k(r) : r;
    const uint16_t* src = a.p + (size_t)(n0 + r) * a.t_out + col0 + col;
    if (vec == 8)
      cp_async<16>(pd + p_offset(sr, col), src);
    else
      cp_async<8>(pd + p_offset(sr, col), src);
  }
}

// Copy chunk c's rows of v_t into v_t stage s2.
template <typename T>
__device__ __forceinline__ void issue_vt(const MmaArgs& a, unsigned char* smem, int c,
                                         int s2) {
  using L = MmaSmem<T>;
  uint16_t* vd =
      reinterpret_cast<uint16_t*>(smem + L::kBOff + 2 * kBTile + s2 * L::vt_tile(a.kv));
  for (int q = threadIdx.x; q < a.k * (kChunk / 8); q += kThreads) {
    const int r = q >> 3, off = 8 * (q & 7);
    cp_async<16>(vd + r * kVPitch + off, a.vt + (size_t)r * a.n_frozen + c * kChunk + off);
  }
}

template <typename T, bool kRows, bool kHoisted>
__global__ void __launch_bounds__(kThreads, 2) gram_mma(const MmaArgs a) {
  using L = MmaSmem<T>;
  using C = CodeTile<T, kRows>;
  constexpr bool kByte = sizeof(T) == 1;
  constexpr bool kPermK = kRows && kByte;   // A's k order permuted within 16
  constexpr bool kPairM = !kRows && kByte;  // A's rows: the items in pairs
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = 16 * warp;  // this warp's 16 rows: warpgroup warp / 4, its 64 rows
  const int ct = blockIdx.x, item0 = blockIdx.y * kItems, col0 = ct * kCols;
  const bool rhs_tile = ct >= a.gram_tiles;
  const bool from_p = kHoisted && !rhs_tile;  // else B is formed from v_t here
  const int c_begin = blockIdx.z * a.chunks_per_seg;
  const int nc = min(a.n_chunks, c_begin + a.chunks_per_seg) - c_begin;
  unsigned char* bsm = smem + L::kBOff;

  // Column col of B^T this thread forms, entries 32 half .. 32 half + 31
  // of each chunk: the rows of v_t it multiplies (x by y, or x by the
  // weight on an rhs tile), and whether it keeps the products.
  const int col = tid & (kCols - 1), half = tid >> 7;
  int xrow = 0, yrow = 0;
  unsigned keep = 0u, weight = kOne2;
  if (rhs_tile) {
    const int kk = (ct - a.gram_tiles) * kHalf + (col & (kHalf - 1));
    weight = col < kHalf ? a.w_code : a.w_ind;
    if (kk < a.k) {
      xrow = kk;
      keep = ~0u;
    }
  } else if (!kHoisted) {
    const int t = col0 + col;
    if (t < a.k * (a.k + 1) / 2) {  // zero past K(K+1)/2
      int j = 0, off = 0;           // column j's segment starts at row off
      while (t >= off + a.k - j) {
        off += a.k - j;
        ++j;
      }
      xrow = j + t - off;
      yrow = j;
      keep = ~0u;
    }
  }
  // B^T's column col, entries 32 half .. + 31, of a chunk from v_t stage
  // s2 into formed tile s2, 16 entries a step by 128-bit loads and stores;
  // with kPermK the pair of entries 4q + 2h of each 16 goes to word 4h + q
  const auto form = [&](int s2) {
    const uint16_t* vt =
        reinterpret_cast<const uint16_t*>(bsm + 2 * kBTile + s2 * L::vt_tile(a.kv));
    const uint4* x = reinterpret_cast<const uint4*>(vt + xrow * kVPitch);
    const uint4* y = reinterpret_cast<const uint4*>(vt + yrow * kVPitch);
    unsigned char* d = bsm + s2 * kBTile;
#pragma unroll
    for (int g = 2 * half; g < 2 * half + 2; ++g) {
      const uint4 x0 = x[2 * g], x1 = x[2 * g + 1];
      uint4 y0 = make_uint4(weight, weight, weight, weight), y1 = y0;
      if (!rhs_tile) {
        y0 = y[2 * g];
        y1 = y[2 * g + 1];
      }
      const unsigned w[8] = {mul_bf16x2(x0.x, y0.x) & keep, mul_bf16x2(x0.y, y0.y) & keep,
                             mul_bf16x2(x0.z, y0.z) & keep, mul_bf16x2(x0.w, y0.w) & keep,
                             mul_bf16x2(x1.x, y1.x) & keep, mul_bf16x2(x1.y, y1.y) & keep,
                             mul_bf16x2(x1.z, y1.z) & keep, mul_bf16x2(x1.w, y1.w) & keep};
      uint4* lo = reinterpret_cast<uint4*>(d + formed_offset(16 * g, col));
      uint4* hi = reinterpret_cast<uint4*>(d + formed_offset(16 * g + 8, col));
      if (kPermK) {
        *lo = make_uint4(w[0], w[2], w[4], w[6]);
        *hi = make_uint4(w[1], w[3], w[5], w[7]);
      } else {
        *lo = make_uint4(w[0], w[1], w[2], w[3]);
        *hi = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  };

  float acc[2][32];  // columns 0-63 and 64-127 of the warpgroup's 64 rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;

  // Copies in flight: the codes (and p) of chunks i + 1 .. i + S - 1 while
  // chunk i is multiplied (S = kStages), v_t's rows of chunk i + 2 while
  // chunk i + 1's B is formed.  Each iteration commits v_t's group, then
  // the codes'.
  constexpr int S = L::kStages;
  for (int c = 0; c < S - 1 && c < nc; ++c)
    issue_chunk<T, kRows, kPermK>(a, smem, item0, col0, from_p, c_begin + c, c);
  if (!from_p)
    for (int c = 0; c < 2 && c < nc; ++c) issue_vt<T>(a, smem, c_begin + c, c);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!from_p) form(0);

  for (int i = 0; i < nc; ++i) {
    // this thread's copies of chunk i, and of v_t's chunk i + 1
    if (from_p)
      cp_async_wait<2 * (S - 2)>();
    else
      cp_async_wait<1>();
    fence_async_shared();  // its writes (and chunk i's B formed) to the tensor cores
    __syncthreads();       // everyone's; chunk i - 1's tiles free
    if (!from_p && i + 2 < nc) issue_vt<T>(a, smem, c_begin + i + 2, i & 1);
    cp_async_commit();
    if (i + S - 1 < nc)
      issue_chunk<T, kRows, kPermK>(a, smem, item0, col0, from_p, c_begin + i + S - 1,
                                    (i + S - 1) % S);
    cp_async_commit();

    // A: this warp's 16 rows of the chunk's codes, 4 k-steps of 16, as
    // bf16: the indicator, or with `values` the codes' values
    const unsigned char* ctile = smem + (i % S) * L::kStage;
    unsigned af[4][4];
    const auto load_a = [&](bool values) {
      load_a_codes<T, kRows>(af, ctile, m0, lane, values);
    };
    // The products of half h (64 columns) over the 4 k-steps, on the
    // chunk's p tile (N-major) or formed B^T (K-major), then `overlap`
    // while they run, then the wait.  The accumulators and A stay held
    // until the tensor cores are done with them.
    const unsigned char* bt = bsm + (from_p ? (i % S) : (i & 1)) * kBTile;
    const auto products = [&](int h0, int h1, auto overlap) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) hold(acc[h][e]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < h0 || h >= h1) continue;
          const uint64_t desc =
              from_p ? b_desc(bt + h * kPHalf + 2 * ks * 1024, kPHalf, 1024, 1)
                     : b_desc(bt + h * 8 * kGroup + 2 * ks * kCore, kCore, kGroup, 0);
          if (from_p)
            wgmma64<1>(acc[h], af[ks], desc);
          else
            wgmma64<0>(acc[h], af[ks], desc);
        }
      wgmma_commit();
      overlap();
      wgmma_wait();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) hold(acc[h][e]);
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) hold(af[ks][q]);
    };
    const auto form_next = [&] {
      if (!from_p && i + 1 < nc) form((i + 1) & 1);
    };
    if (!rhs_tile) {
      load_a(false);
      products(0, 2, form_next);  // chunk i + 1's B is formed meanwhile
    } else {  // columns 0-63 on the codes' values, 64-127 on the indicator
      load_a(true);
      products(0, 1, [] {});
      load_a(false);
      products(1, 2, form_next);
    }
  }

  // Epilogue.  acc[h][4j + 2e + c] holds row m0 + g + 8e (kPairM: m0 + 2g
  // + e) and column 64h + 8j + 2tg + c.
  const int g = lane >> 2, tg = lane & 3;
  const auto row_of = [&](int e) { return m0 + (kPairM ? 2 * g + e : g + 8 * e); };
  const bool split = gridDim.z > 1;
  if (!rhs_tile) {
    const int pitch = split ? a.pw : a.t_out;
    float* base = split ? a.partial + ((size_t)blockIdx.z * a.items + item0) * a.pw
                        : a.gram + (size_t)item0 * a.t_out;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 64 * h + 8 * j + 2 * tg;  // even, t_out % 4 == 0
        if (c >= a.t_out) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(base + (size_t)row_of(e) * pitch + c) =
              make_float2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
      }
  } else {
    // the codes half (h = 0) and the indicator half (h = 1) of one entry
    // lie in the same thread
    const int kk0 = (ct - a.gram_tiles) * kHalf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = kk0 + 8 * j + 2 * tg;
      if (kk >= a.k) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row_of(e);
        const float x0 = a.alpha * acc[0][4 * j + 2 * e] + a.beta * acc[1][4 * j + 2 * e];
        const float x1 =
            a.alpha * acc[0][4 * j + 2 * e + 1] + a.beta * acc[1][4 * j + 2 * e + 1];
        if (split) {  // kk + 1 < pw - t_out: a float2 of the partial
          *reinterpret_cast<float2*>(a.partial +
                                     ((size_t)blockIdx.z * a.items + item0 + r) * a.pw +
                                     a.t_out + kk) = make_float2(x0, x1);
        } else {
          float* d = a.rhs + (size_t)(item0 + r) * a.k + kk;
          d[0] = x0;
          if (kk + 1 < a.k) d[1] = x1;
        }
      }
    }
  }
  if (!split) return;

  // S > 1: the last of the tile's S blocks sums the partials in segment
  // order, read through L2 (other SMs wrote them), and resets the counter
  __shared__ int last_block;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    const int prev = atomicAdd(a.arrivals + tile, 1);
    last_block = prev == (int)gridDim.z - 1;
    if (last_block) a.arrivals[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int n_seg = gridDim.z;
  const size_t seg = (size_t)a.items * a.pw;
  if (!rhs_tile) {
    const int n4 = min(kCols, a.t_out - col0) / 4;
    for (int e = tid; e < kItems * n4; e += kThreads) {
      const int r = e / n4, c4 = col0 + 4 * (e - r * n4);
      const float* src = a.partial + (size_t)(item0 + r) * a.pw + c4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int z = 0; z < n_seg; ++z) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(src + z * seg));
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      *reinterpret_cast<float4*>(a.gram + (size_t)(item0 + r) * a.t_out + c4) = s;
    }
  } else {
    const int kk0 = (ct - a.gram_tiles) * kHalf, nk = min(kHalf, a.k - kk0);
    for (int e = tid; e < kItems * nk; e += kThreads) {
      const int r = e / nk, kk = kk0 + (e - r * nk);
      const float* src = a.partial + (size_t)(item0 + r) * a.pw + a.t_out + kk;
      float s = 0.f;
      for (int z = 0; z < n_seg; ++z) s += __ldcg(src + z * seg);
      a.rhs[(size_t)(item0 + r) * a.k + kk] = s;
    }
  }
}

template <typename T, bool kRows, bool kHoisted>
int launch_mma(dim3 grid, cudaStream_t s, const MmaArgs& a) {
  // above 48 KB only after the attribute is raised (once per instance and
  // device, to the most any K needs), and the carveout at its largest so
  // that two blocks share an SM
  static int configured = -1;
  const auto kernel = gram_mma<T, kRows, kHoisted>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MmaSmem<T>::bytes(kMaxK));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = dev;
  }
  kernel<<<grid, kThreads, MmaSmem<T>::bytes(a.kv), s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mma(dim3 grid, cudaStream_t s, const MmaArgs& a, bool rows) {
  if (a.p != nullptr)
    return rows ? launch_mma<T, true, true>(grid, s, a) : launch_mma<T, false, true>(grid, s, a);
  return rows ? launch_mma<T, true, false>(grid, s, a) : launch_mma<T, false, false>(grid, s, a);
}

}  // namespace

// The library's C entry point.  codes is [n_rows, n_cols] row-major, of
// code_bytes bytes each (1: int8, 2: int16), on a 16-byte boundary; rows
// != 0 makes the code rows the items.  The items are a multiple of 128,
// the frozen entries of 64 (the dense8 arrays' are multiples of 512).
// v_t is [k, N] bf16 row-major (N = the frozen count) on a 16-byte
// boundary.  p == null selects #3 (t_out >= k(k+1)/2, rows past it zero);
// else #4 sums p [N, t_out] bf16 row-major on a 16-byte boundary.  t_out is
// a multiple of 4.  The frozen axis's 64-entry chunks are split into
// `segments` runs of `chunks_per_seg` (every run non-empty); with more than
// one, `partial` is a float32 scratch [segments, items, t_out + roundup(k,
// 4)] and `arrivals` an int32 [items / 128 x column tiles] that is zero
// before the launch and left zero after it, so launches that share it must
// be ordered (one stream).  smem_bytes is ops/dense8.mma_plan's, which must
// agree with this library's layout.  gram [items, t_out] and rhs [items, k]
// are float32.  Launches on `stream`, returns cudaGetLastError().
extern "C" int bpmf_dense8_gram_mma(const void* codes, int code_bytes, int n_rows,
                                    int n_cols, int rows, int k, const void* v_t,
                                    const void* p, int t_out, float cs, float cb,
                                    int segments, int chunks_per_seg, int smem_bytes,
                                    void* partial, void* arrivals, void* gram,
                                    void* rhs, void* stream) {
  const int items = rows ? n_rows : n_cols;
  const int n_frozen = rows ? n_cols : n_rows;
  const int kv = (k + 7) / 8 * 8;
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  if (k < 1 || k >= kMaxK || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (items < kItems || items % kItems != 0 || items / kItems > 65535 ||
      n_frozen < kChunk || n_frozen % kChunk != 0 || n_cols % 16 != 0 ||
      !aligned(codes) || !aligned(v_t) || t_out < 4 || t_out % 4 != 0 ||
      (p == nullptr && t_out < k * (k + 1) / 2) || (p != nullptr && !aligned(p)))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = n_frozen / kChunk;
  if (segments < 1 || segments > 65535 || chunks_per_seg < 1 ||
      (long long)segments * chunks_per_seg < n_chunks ||
      (long long)(segments - 1) * chunks_per_seg >= n_chunks ||
      (segments > 1 && (partial == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int expect = code_bytes == 1 ? MmaSmem<int8_t>::bytes(kv) : MmaSmem<int16_t>::bytes(kv);
  if (smem_bytes != expect) return (int)cudaErrorInvalidValue;
  const int gram_tiles = (t_out + kCols - 1) / kCols;
  const int rhs_tiles = (k + kHalf - 1) / kHalf;
  const bool hoisted = p != nullptr;
  const MmaArgs a{static_cast<const unsigned char*>(codes), n_cols, items,
                  n_frozen, k, kv, t_out, t_out + (k + 3) / 4 * 4,
                  static_cast<const uint16_t*>(v_t), static_cast<const uint16_t*>(p),
                  hoisted ? 1.f : cs, hoisted ? 1.f : cb,
                  hoisted ? bf16x2_of(cs) : kOne2, hoisted ? bf16x2_of(cb) : kOne2,
                  gram_tiles, n_chunks, chunks_per_seg,
                  static_cast<float*>(partial), static_cast<int*>(arrivals),
                  static_cast<float*>(gram), static_cast<float*>(rhs)};
  const dim3 grid(gram_tiles + rhs_tiles, items / kItems, segments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return code_bytes == 1 ? dispatch_mma<int8_t>(grid, s, a, rows != 0)
                         : dispatch_mma<int16_t>(grid, s, a, rows != 0);
}
