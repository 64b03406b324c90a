// dense8 half-sweep megakernel on bf16 operands for Hopper (sm_90a), on the
// tensor cores: #1 and #2 at Config.matmul_dtype = "bfloat16" and K <= 32
// (the library dense8_sweep_solve_mma, loaded by ops/dense8.py).
//
// Replaces, on bf16 operands, the TPU kernels bpmf_tpu/ops/dense8.py:580
// _kernel_fused_solve_inpt (#1: the packed products formed in the kernel,
// launched at :665) and :509 _kernel_fused_solve (#2: the products
// streamed from a hoisted operand p_t in the tight or the aligned layout,
// launched at :758).  Each is a dense MXU product of a bf16 operand
// against the indicator of the code tile, then the prior, the Cholesky,
// both solves and the draw, in one launch; so is this kernel.  For the
// items i of one side over every frozen entry n, ind = (code != 0):
//
//   G[i, t] = sum_n ind[i, n] p[n, t]       (the lower triangle, tight order)
//   r[i, k] = alpha_r sum_n code[i, n] wy[n, k] + beta_r sum_n ind[i, n] wx[n, k]
//   A_i = lam + alpha G_i,  L L' = A_i,  u_i = L' \ (L \ (r_i + prior) + noise_i)
//
//   #1: p[n, t] = bf16(v[n, a_t] v[n, b_t]), formed here by mul.rn.bf16x2
//       (the TPU kernel's pa * pb in bf16); wx = wy = v; alpha_r = cs,
//       beta_r = cb;
//   #2: p is the caller's [N, T_in] rows in its layout, read whole (the
//       aligned layout's padding rows too, whose sums are dropped); wy =
//       bf16(bf16(cs) v), wx = bf16(bf16(cb) v); alpha_r = beta_r = 1 (the
//       default fold, ops/dense8.py fold_weights).
//
// Every product is exact (a {0,1} or an integer code times a bf16 value,
// or two bf16 values) and every sum float32, so the sums are the JAX
// package's up to their order; the solve is the float32 kernel's
// (warp_chol.cuh solve_rows_regs).
//
// What bounds it on an H100.  At [6144, 4096], K=32, 4% rated, the bytes
// it must move (the codes, v or p, the noise and the draws, once) take
// 0.016-0.019 ms a side pair at 3.35 TB/s, and the rated entries'
// operations less; but the work done here is dense: items x frozen x
// (T + 2K) multiply-adds whatever the density (the dense floor, 0.030 ms
// an orientation at 989 TFLOP/s at T = 528), as on the TPU.  The walk
// (dense8_sweep_solve.cuh's bf16 instances) does only the rated entries'
// work, a rated row at a time on the CUDA cores, so below a density
// measured on the card (ops/dense8.sweep_bf16_kernel) it stays the one
// that runs.
//
// Design.
//
// * A block owns 128 items (two of wgmma's 64) and a group of column
//   units: two 64-column Gram tiles (#1's products in the tight order at
//   the capacity KP, zero past KP(KP+1)/2; #2's rows of p), or, in the last
//   group, the rhs: one formed tile [wx | wy] multiplied by the indicator
//   into one slot and by the values into the other (m64n64k16 each, so
//   that every wgmma of a block has one shape and whole accumulators:
//   ptxas serialized them when an m64nKP rhs product shared a Gram
//   tile's sums).  The frozen axis goes in 64-entry chunks, over one
//   segment of it a block (ops/dense8.sweep_mma_plan: a cost model of the
//   waves of blocks, a block an SM, by the card's timings).
// * Warp-specialized, 512 threads: two producer warpgroups copy each
//   chunk's codes, p's tiles (16-byte cp.async into the 128-byte swizzle,
//   N-major) and v_t's rows into a ring of stages (4 with int8 codes, 3
//   with int16) three chunks ahead, and form the chunk's B K-major from
//   v_t's rows (#1's products by mul.rn.bf16x2, the TPU kernel's pa * pb in
//   bf16; [wx | wy]), a thread a column and 16 entries; two consumer
//   warpgroups (64 items each, both on the group's units) convert A from
//   the codes as they lie (dense8_mma.cuh) and run the products on the
//   stage while the producers form the next.  Stages change hands by
//   named barriers (full, empty); setmaxnreg gives the consumers 184
//   registers and the producers 72 while the products run.
// * Every block writes its units' sums to a scratch [S, items,
//   KP(KP+1)/2 + KP] (the Gram in the tight order at the system's K, #2's
//   padding rows dropped through the inverse of the wrapper's entry-to-row
//   map; the rhs alpha_r * values + beta_r * indicator), then arrives on
//   its item block's counter and waits for the item block's other groups
//   x S blocks: blocks take their work by a ticket as they start, so all
//   of them are running or done, and the plan keeps groups x S within the
//   card's SMs.  Then each solves its share of the items: their S
//   partials summed in segment order into shared memory (no float
//   atomics: a launch is bitwise equal to the next), A = lam + alpha G,
//   and the float32 megakernel's register Cholesky (warp_chol.cuh), a warp
//   an item.
//
// Known limits (H100 80GB HBM3; phase timers at [6144, 4096], K=32): a
// chunk costs a consumer warpgroup ~1,900 cycles against ~500 of
// tensor time (~1,600 without its wgmma, ~2,100 without its A conversion:
// neither sets it), the producers' forming ~1,100; a block's share of the
// solves ~27,000 cycles and its wait for the item block ~13,000.  It runs
// at ~12% of its dense floor's rate (0.49 against 0.060 ms, rows + cols),
// and a short frozen axis pays the blocks' fixed work (chembl's compounds,
// 8 chunks a block: 1.88 ms against the walk's 0.75).
//
// Capacities KP 8, 16, 24, 32 (the wrapper pads a smaller K block-
// diagonally, as for the walk: zero rows of v_t, the identity on the
// prior's extra diagonal, zero prior rhs and noise); #2 reads a runtime K
// <= KP through the entry-to-row map.  K 33-41 stay on the walk.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense8_mma.cuh"    // wgmma, the code tiles as A, B's layouts
#include "dense8_stage.cuh"  // cp_async, mul_bf16x2
#include "warp_chol.cuh"     // solve_rows_regs

namespace {

using bpmf::cp_async;
using bpmf::cp_async_commit;
using bpmf::cp_async_wait;
using bpmf::lcol_floats;
using bpmf::mul_bf16x2;
using bpmf::round4;
using bpmf::tight_off;

constexpr int kItems = kTileItems;   // items a block: two of wgmma's M
constexpr int kWarpgroups = 4;       // two consumers (64 items each), two producers
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kConsumers = 256;      // the consumers' threads, then the producers'
constexpr int kProducers = kThreads - kConsumers;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;            // units a consumer warpgroup holds
constexpr int kSolveItems = kWarps;  // items summed into shared memory at once
// named barriers (0 is __syncthreads): a stage full, a stage empty, the
// producers among themselves
constexpr int kBarFull = 1, kBarEmpty = 5, kBarProd = 9;

// Stages: 4 with int8 codes, 3 with int16
__host__ __device__ constexpr int stages_of(int code_bytes) { return code_bytes == 1 ? 4 : 3; }
constexpr int kTileBytes = 64 * kChunk * 2;  // a 64-column bf16 B tile
constexpr int kVPitch = kChunk + 8;  // bf16 v_t [k][entry] stage
constexpr int kSmemLimit = 232448;   // an H100 block's dynamic shared memory

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A stage of codes (CodeTile): the larger of the two orientations'
// layouts, so that one room serves both.
__host__ __device__ inline int code_stage_bytes(int code_bytes) {
  const int rows = kItems * (kChunk * code_bytes + 16);
  const int cols = kChunk * (kItems * code_bytes + 16);
  return rows > cols ? rows : cols;  // multiples of 1 KB
}

// The column groups of an instance of `cols` Gram columns (#1:
// KP(KP+1)/2, #2: T_in): tp Gram tiles of 64, two to a group (the last
// may hold one), then the rhs group, each a block's.
struct Plan {
  int tp, groups, tiles_max;
};

__host__ __device__ inline Plan plan_of(int cols) {
  Plan p;
  p.tp = (cols + 63) / 64;
  p.groups = (p.tp + kSlots - 1) / kSlots + 1;
  p.tiles_max = p.tp < kSlots ? p.tp : kSlots;
  return p;
}

// Byte offsets of the dynamic shared memory, from its first 1 KB boundary
// (ops/dense8.sweep_mma_plan computes the same bytes): stages_of() stages,
// each the chunk's codes, its Gram tiles' B (#2: p's rows; #1: formed),
// the rhs group's B (formed: wx and wy, KP columns each) and its rows of
// v_t, then a table (#1: the two rows of v of each of a group's
// formed columns; #2: p's row to entry).  After the products, the solve
// reuses it from 0: the summed partials of kSolveItems items, the prior
// [KP][KP + 1], then each warp's two factor column stores.
struct Layout {
  int stage, p, v, vt, table, bytes;  // p, v, vt: offsets in a stage
};

__host__ __device__ inline Layout layout_of(int code_bytes, int kp, bool hoisted, int t_in) {
  const Plan pl = plan_of(hoisted ? t_in : kp * (kp + 1) / 2);
  Layout l;
  l.p = code_stage_bytes(code_bytes);
  l.v = l.p + pl.tiles_max * kTileBytes;
  l.vt = l.v + kTileBytes;
  l.stage = l.vt + (kp * kVPitch * 2 + 1023) / 1024 * 1024;
  l.table = stages_of(code_bytes) * l.stage;
  const int end = l.table + 4 * (hoisted ? round4(t_in) : 64 * pl.tiles_max);
  const int solve =
      4 * (kSolveItems * (kp * (kp + 1) / 2 + kp) + round4(kp * (kp + 1)) +
           kWarps * lcol_floats(kp));
  l.bytes = 1024 + (end > solve ? end : solve);
  return l;
}

struct Args {
  const unsigned char* codes;
  int n_cols;              // the code array's row pitch, in codes
  int items, n_frozen, k_sys;
  const uint16_t* vt;      // v_t [KP, n_frozen] bf16
  const uint16_t* p;       // #2: [n_frozen, t_in] bf16; #1: null
  const int* p_rows;       // #2: the row of p of each tight entry at k_sys
  int t_in;
  const float *lam, *prior, *noise;  // [KP, KP], [KP], [items, KP]
  float alpha_r, beta_r;   // rhs = alpha_r (values) + beta_r (indicator)
  unsigned w_x, w_y;       // bf16x2 weights of v in the rhs unit's halves
  float alpha;
  Plan pl;
  Layout ly;
  int n_chunks, chunks_per_seg;
  float* partial;          // [S, items, KP(KP+1)/2 + KP]
  int segments;
  int* counters;           // [2 + 2 items / kItems], zero between launches
  float* out;              // [items, KP]
};

// One block: the units of a group for the 128 items of an item block over
// a segment of the frozen axis (by its ticket), then, with the item
// block's other blocks, the solve of its share of the items.
template <typename T, bool kRows, bool kHoisted, int KP>
__global__ void __launch_bounds__(kThreads, 1) sweep_solve_mma(const Args a) {
  using C = CodeTile<T, kRows>;
  constexpr bool kByte = sizeof(T) == 1;
  constexpr bool kPermK = kRows && kByte;   // A's k order permuted within 16
  constexpr bool kPairM = !kRows && kByte;  // A's rows: the items in pairs
  constexpr int kTE = KP * (KP + 1) / 2;    // the tight Gram's entries
  constexpr int kPW = kTE + KP;             // floats of an item's partial
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int ticket_s;
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup, broadcast so that the compiler sees it warp-uniform (a
  // branch on it must not serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int m0 = 64 * (wg & 1) + 16 * (warp & 3);  // a consumer warp's 16 rows
  constexpr int kStages = stages_of(sizeof(T));
  const Plan pl = a.pl;
  // The block's work by a ticket taken as it starts, item block by item
  // block: every block of its item block with a smaller ticket is running
  // or done, so that waiting for them (below) cannot deadlock while an
  // item block's groups x segments blocks fit on the card at once.
  if (tid == 0) ticket_s = atomicAdd(a.counters, 1);
  __syncthreads();
  const int gs = pl.groups * a.segments;  // blocks an item block
  const int iblock = ticket_s / gs, rank = ticket_s - iblock * gs;
  const int group = rank % pl.groups, seg = rank / pl.groups;
  const int item0 = iblock * kItems;
  const int c_begin = seg * a.chunks_per_seg;
  const int nc = min(a.n_chunks, c_begin + a.chunks_per_seg) - c_begin;
  // the group's Gram tiles u0, u0 + 1 (both consumers hold them), or the
  // rhs: the indicator against [wx | wy] in slot 0, the values in slot 1
  const bool rhs_group = group == pl.groups - 1;
  const int u0 = kSlots * group;
  const int n_tiles = rhs_group ? 0 : min(kSlots, pl.tp - u0);
  const bool forms = !kHoisted || rhs_group;  // B formed from v_t here

  int* table = reinterpret_cast<int*>(smem + a.ly.table);
  const auto stage = [&](int st) { return smem + st * a.ly.stage; };

  // The tables: #1, the rows (x, y) of v whose products form each of this
  // group's Gram columns (x | y << 8 | kept << 16; zero past the
  // triangle); #2, the tight entry of each row of p (-1: a padding row)
  if constexpr (kHoisted) {
    for (int r = tid; r < round4(a.t_in); r += kThreads) table[r] = -1;
    __syncthreads();
    const int ne = a.k_sys * (a.k_sys + 1) / 2;
    for (int e = tid; e < ne; e += kThreads) table[__ldg(a.p_rows + e)] = e;
  } else {
    for (int c = tid; c < 64 * n_tiles; c += kThreads) {
      const int t = 64 * u0 + c;
      int info = 0;
      if (t < kTE) {
        int j = 0;
        while (t >= tight_off(j + 1, KP)) ++j;
        info = (j + t - tight_off(j, KP)) | j << 8 | 1 << 16;
      }
      table[c] = info;
    }
  }
  __syncthreads();  // the tables

  if (wg >= 2) {
    // the producers need few registers, the consumers' sums many: 72 and
    // 184 a thread while the products run (65,536 in all), 128 after
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    // Producers: chunk c's B is formed from its v_t rows and the stage
    // handed to the consumers, which multiply it while chunk c + 1 is
    // formed; the copies (codes, p's tiles, v_t's rows into stage c %
    // kStages) go out kStages - 1 chunks ahead, once the consumers are
    // done with the chunk kStages before
    const int ptid = tid - kConsumers;
    const auto issue = [&](int c, int st) {
      unsigned char* base = stage(st);
      const int n0 = c * kChunk;
      constexpr int kPieces = C::kRowBytes / 16 - 1;  // 16-byte copies a row
      for (int q = ptid; q < C::kRowsOf * kPieces; q += kProducers) {
        const int r = q / kPieces, off = 16 * (q - r * kPieces);
        const size_t at = kRows ? (size_t)(item0 + r) * a.n_cols + n0
                                : (size_t)(n0 + r) * a.n_cols + item0;
        cp_async<16>(base + r * C::kRowBytes + off, a.codes + at * sizeof(T) + off);
      }
      if constexpr (kHoisted) {
        // this group's tiles of p's rows n0 .. n0 + 63, swizzled (p_offset):
        // 128-byte runs into whole rows of an atom; with kPermK row r goes
        // to perm_k(r) (the mma's k order)
        unsigned char* pd = base + a.ly.p;
        const int lg = a.t_in % 8 == 0 ? 3 : 4;  // log2 copies a row of a tile:
        const int vec = 64 >> lg;                // 16 or 8 bytes each
        const int per_tile = kChunk << lg;
        for (int q = ptid; q < n_tiles * per_tile; q += kProducers) {
          const int l = q >> (6 + lg), rem = q & (per_tile - 1);
          const int r = rem >> lg, col = vec * (rem & ((1 << lg) - 1));
          const int gcol = 64 * (u0 + l) + col;
          if (gcol >= a.t_in) continue;  // past p: a column never read
          const uint16_t* src = a.p + (size_t)(n0 + r) * a.t_in + gcol;
          unsigned char* d = pd + l * kTileBytes + p_offset(kPermK ? perm_k(r) : r, col);
          if (vec == 8)
            cp_async<16>(d, src);
          else
            cp_async<8>(d, src);
        }
      }
      if (forms) {
        uint16_t* vd = reinterpret_cast<uint16_t*>(base + a.ly.vt);
        for (int q = ptid; q < KP * (kChunk / 8); q += kProducers) {
          const int r = q >> 3, off = 8 * (q & 7);
          cp_async<16>(vd + r * kVPitch + off, a.vt + (size_t)r * a.n_frozen + n0 + off);
        }
      }
    };
    // B of the chunk in stage st from its v_t rows: #1's Gram columns (the
    // products of two rows of v, mul.rn.bf16x2) and the rhs unit's (a row
    // of v times its weight: 1, or #2's bf16 cb and cs), a thread a column
    // and 16 entries, the columns fastest so that a quarter warp stores 128
    // contiguous bytes; with kPermK the pair of entries 4q + 2h of each 16
    // goes to word 4h + q
    const auto form = [&](int st) {
      unsigned char* base = stage(st);
      const uint16_t* vt = reinterpret_cast<const uint16_t*>(base + a.ly.vt);
      const int ncol_p = kHoisted ? 0 : 64 * n_tiles;
      const int ncol = ncol_p + (rhs_group ? 2 * KP : 0);
      for (int q = ptid; q < 4 * ncol; q += kProducers) {
        const int g = q / ncol, col = q - g * ncol;
        int xrow, yrow = 0;
        unsigned keep = ~0u, weight = kOne2;
        unsigned char* d;
        if (col < ncol_p) {
          const int info = table[col];
          xrow = info & 255;
          yrow = (info >> 8) & 255;
          keep = info >> 16 ? ~0u : 0u;
          d = base + a.ly.p + formed_offset(16 * g, col);
        } else {
          const int vc = col - ncol_p;
          xrow = vc < KP ? vc : vc - KP;
          weight = vc < KP ? a.w_x : a.w_y;
          d = base + a.ly.v + formed_offset(16 * g, vc);
        }
        const uint4* x = reinterpret_cast<const uint4*>(vt + xrow * kVPitch) + 2 * g;
        const uint4* y = reinterpret_cast<const uint4*>(vt + yrow * kVPitch) + 2 * g;
        const bool product = col < ncol_p;
        // entries 8h .. 8h + 7: words 4h .. 4h + 3 of the 16's eight
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 xv = x[h];
          const uint4 yv = product ? y[h] : make_uint4(weight, weight, weight, weight);
          const unsigned w0 = mul_bf16x2(xv.x, yv.x) & keep, w1 = mul_bf16x2(xv.y, yv.y) & keep,
                         w2 = mul_bf16x2(xv.z, yv.z) & keep, w3 = mul_bf16x2(xv.w, yv.w) & keep;
          if (kPermK) {  // words 4h + q of lo (q even) and hi (q odd)
            *reinterpret_cast<uint2*>(d + 8 * h) = make_uint2(w0, w2);
            *reinterpret_cast<uint2*>(d + kCore + 8 * h) = make_uint2(w1, w3);
          } else {
            *reinterpret_cast<uint4*>(d + kCore * h) = make_uint4(w0, w1, w2, w3);
          }
        }
      }
    };
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nc) issue(c_begin + c, c);
      cp_async_commit();
    }
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this thread's copies of chunk c
      bar_sync(kBarProd, kProducers);  // everyone's; chunk c - 1 formed
      if (forms) form(c % kStages);
      fence_async_shared();  // the copies and the formed B to the tensor cores
      bar_arrive(kBarFull + c % kStages, kThreads);
      // then the stage of chunk c - 1, once the consumers are done with it,
      // takes chunk c + kStages - 1
      const int cn = c + kStages - 1;
      if (cn < nc) {
        if (cn >= kStages) bar_sync(kBarEmpty + cn % kStages, kThreads);
        issue(c_begin + cn, cn % kStages);
      }
      cp_async_commit();
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 128;\n");
  } else {
    // Consumers: A from the chunk's codes, the products on its B
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n");
    // A chunk's products accumulate in the tensor cores from zero (acc),
    // then go into float32 sums on the CUDA cores (sum): the tensor cores'
    // float32 accumulation of a long run of an item's ratings (61,253 of
    // chembl's most-rated protein) strays past float32's bound, a chunk's
    // 64 do not
    float acc[kSlots][32], sum[kSlots][32];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[s][e] = sum[s][e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int st = c % kStages;
      bar_sync(kBarFull + st, kThreads);
      const unsigned char* ctile = stage(st);
      const unsigned char* pt = ctile + a.ly.p;
      const unsigned char* vb = ctile + a.ly.v;
      // A: this warp's 16 rows of the chunk's codes as bf16
      unsigned af[4][4];
      const auto load_a = [&](bool values) {
        load_a_codes<T, kRows>(af, ctile, m0, lane, values);
      };
      const auto hold_all = [&] {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
#pragma unroll
          for (int e = 0; e < 32; ++e) hold(acc[s][e]);
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) hold(af[ks][q]);
      };
      // Every sequence of wgmma below is straight: its shapes and
      // accumulators fixed (a branch among them, or an rhs product into
      // part of a Gram tile's sums, and ptxas serializes them)
      if (rhs_group) {
        // [wx | wy] (K-major): the values against it into slot 1, then the
        // indicator into slot 0
        load_a(true);
        hold_all();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
          wgmma64<0>(acc[1], af[ks], b_desc(vb + 2 * ks * kCore, kCore, kGroup, 0), ks);
        wgmma_commit();
        wgmma_wait();
        hold_all();
        load_a(false);
        hold_all();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
          wgmma64<0>(acc[0], af[ks], b_desc(vb + 2 * ks * kCore, kCore, kGroup, 0), ks);
      } else {
        // the indicator against the group's Gram tiles
        load_a(false);
        hold_all();
        wgmma_fence();
        if (n_tiles == kSlots) {
#pragma unroll
          for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              const unsigned char* tile = pt + s * kTileBytes;
              if constexpr (kHoisted)
                wgmma64<1>(acc[s], af[ks], b_desc(tile + 2 * ks * 1024, kPHalf, 1024, 1), ks);
              else
                wgmma64<0>(acc[s], af[ks], b_desc(tile + 2 * ks * kCore, kCore, kGroup, 0), ks);
            }
        } else {
#pragma unroll
          for (int ks = 0; ks < kChunk / 16; ++ks) {
            if constexpr (kHoisted)
              wgmma64<1>(acc[0], af[ks], b_desc(pt + 2 * ks * 1024, kPHalf, 1024, 1), ks);
            else
              wgmma64<0>(acc[0], af[ks], b_desc(pt + 2 * ks * kCore, kCore, kGroup, 0), ks);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
      hold_all();
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[s][e] += acc[s][e];
      if (c + kStages < nc) bar_arrive(kBarEmpty + st, kThreads);  // the stage is free
    }

    // The consumers' sums to the scratch.  sum[s][4j + 2e + c] holds row
    // m0 + g + 8e (kPairM: m0 + 2g + e) and column 8j + 2tg + c of the unit.
    const int g = lane >> 2, tg = lane & 3;
    const auto row_of = [&](int e) { return m0 + (kPairM ? 2 * g + e : g + 8 * e); };
    float* part = a.partial + ((size_t)seg * a.items + item0) * kPW;
    if (rhs_group) {
      // rhs = alpha_r (values, wy: columns KP ..) + beta_r (indicator, wx:
      // columns 0 ..), both in this thread (KP % 8 == 0)
#pragma unroll
      for (int j = 0; j < KP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int at = 4 * j + 2 * e + c;
            part[row_of(e) * kPW + kTE + 8 * j + 2 * tg + c] =
                a.alpha_r * sum[1][at + KP / 2] + a.beta_r * sum[0][at];
          }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s >= n_tiles) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 64 * (u0 + s) + 8 * j + 2 * tg + c;
            if (!kHoisted && c == 0 && col + 1 < kTE) {  // #1: both as a float2
#pragma unroll
              for (int e = 0; e < 2; ++e)
                *reinterpret_cast<float2*>(part + row_of(e) * kPW + col) =
                    make_float2(sum[s][4 * j + 2 * e], sum[s][4 * j + 2 * e + 1]);
              break;
            }
            int entry;
            if constexpr (kHoisted)
              entry = col < a.t_in ? table[col] : -1;
            else
              entry = col < kTE ? col : -1;
            if (entry < 0) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) part[row_of(e) * kPW + entry] = sum[s][4 * j + 2 * e + c];
          }
      }
    }

    asm volatile("setmaxnreg.dec.sync.aligned.u32 128;\n");
  }

  // Arrive, and wait for the item block's other blocks: then its sums
  // are complete in the scratch (read through L2, other SMs wrote them),
  // and this block solves its items rank, rank + gs, ...
  int* arrived = a.counters + 2 + iblock;
  int* departed = arrived + a.items / kItems;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (tid == 0) {
    atomicAdd(arrived, 1);
    // a block's products take milliseconds; a wait of a minute is a fault
    // of the plan (blocks that never run), which becomes an error
    const long long t0 = clock64();
    while (*reinterpret_cast<volatile int*>(arrived) < gs) {
      __nanosleep(128);
      if (clock64() - t0 > (1ll << 37)) __trap();
    }
  }
  __syncthreads();
  __threadfence();

  // The S partials of up to kWarps of its items at a time, summed in
  // segment order into shared memory by the whole block (float4s, many in
  // flight); then a warp an item, its A = lam + alpha G in the lanes'
  // rows, with the register Cholesky of warp_chol.cuh.  The order of every
  // sum is fixed, whichever block solves an item: launches are bitwise
  // equal.
  float* sums = reinterpret_cast<float*>(smem);     // [kSolveItems][kPW]
  float* lam_s = sums + kSolveItems * kPW;          // [KP][KP + 1]
  float* w = lam_s + round4(KP * (KP + 1)) + warp * lcol_floats(KP);
  for (int q = tid; q < KP * KP; q += kThreads)
    lam_s[(q / KP) * (KP + 1) + q % KP] = __ldg(a.lam + q);
  const int kk = a.k_sys;
  const size_t seg4 = (size_t)a.items * kPW / 4;
  const int mine = (kItems - rank + gs - 1) / gs;  // items it solves
  const bool live = lane < KP;
  for (int b0 = 0; b0 < mine; b0 += kSolveItems) {
    const int n = min(kSolveItems, mine - b0);
    __syncthreads();  // the last items' sums are read
#pragma unroll 4
    for (int q = tid; q < n * (kPW / 4); q += kThreads) {
      const int li = q / (kPW / 4), r4 = q - li * (kPW / 4);
      const size_t item = (size_t)item0 + rank + (size_t)gs * (b0 + li);
      const float4* src4 = reinterpret_cast<const float4*>(a.partial + item * kPW) + r4;
      float4 x = __ldcg(src4);
      for (int z = 1; z < a.segments; ++z) {
        const float4 y = __ldcg(src4 + z * seg4);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      reinterpret_cast<float4*>(sums)[q] = x;
    }
    __syncthreads();
    if (warp >= n) continue;
    const size_t item = (size_t)item0 + rank + (size_t)gs * (b0 + warp);
    const float* gi = sums + warp * kPW;
    float gr[1][KP], y[1], noise[1];
    // the lower triangle is what the solve reads; lam's padding past the
    // system's K is the identity
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const float gj = (j <= lane && lane < kk) ? gi[tight_off(j, kk) + lane - j] : 0.f;
      gr[0][j] = live ? fmaf(a.alpha, gj, lam_s[lane * (KP + 1) + j]) : 0.f;
    }
    y[0] = live ? gi[kTE + lane] + __ldg(a.prior + lane) : 0.f;
    noise[0] = live ? __ldg(a.noise + item * KP + lane) : 0.f;
    bpmf::solve_rows_regs<KP>(gr, y, noise, w, KP, a.out + item * KP);
  }

  // Depart: the item block's last block resets its counters, the grid's
  // last block the ticket and the count of blocks done
  __syncthreads();
  if (tid == 0) {
    if (atomicAdd(departed, 1) == gs - 1) {
      *arrived = 0;
      *departed = 0;
    }
    if (atomicAdd(a.counters + 1, 1) == (int)gridDim.x - 1) {
      a.counters[0] = 0;
      a.counters[1] = 0;
    }
  }
}

template <typename T, bool kRows, bool kHoisted, int KP>
int launch(dim3 grid, cudaStream_t s, const Args& a) {
  // above 48 KB only after the attribute is raised (per instance and
  // device, to the most bytes asked yet)
  static int configured_dev = -1, configured_bytes = 0;
  const auto kernel = sweep_solve_mma<T, kRows, kHoisted, KP>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured_dev != dev || a.ly.bytes > configured_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a.ly.bytes);
    if (err == cudaSuccess)  // the carveout at its largest: two blocks an SM
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured_dev = dev;
    configured_bytes = a.ly.bytes;
  }
  kernel<<<grid, kThreads, a.ly.bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kRows, bool kHoisted>
int by_capacity(int kp, dim3 grid, cudaStream_t s, const Args& a) {
  switch (kp) {
    case 8: return launch<T, kRows, kHoisted, 8>(grid, s, a);
    case 16: return launch<T, kRows, kHoisted, 16>(grid, s, a);
    case 24: return launch<T, kRows, kHoisted, 24>(grid, s, a);
    case 32: return launch<T, kRows, kHoisted, 32>(grid, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int kp, bool rows, dim3 grid, cudaStream_t s, const Args& a) {
  if (a.p != nullptr)
    return rows ? by_capacity<T, true, true>(kp, grid, s, a)
                : by_capacity<T, false, true>(kp, grid, s, a);
  return rows ? by_capacity<T, true, false>(kp, grid, s, a)
              : by_capacity<T, false, false>(kp, grid, s, a);
}

}  // namespace

// The library's C entry point.  codes is [n_rows, n_cols] row-major, of
// code_bytes bytes each (1: int8, 2: int16), on a 16-byte boundary; rows
// != 0 makes the code rows the items.  The items are a multiple of 128, the
// frozen entries of 64 (the dense8 arrays' are multiples of 512), n_cols of
// 16.  kp is the capacity (8, 16, 24 or 32); v_t is [kp, N] bf16 row-major
// on a 16-byte boundary (N = the frozen count), the system padded past its
// K with zero rows.  p == null selects #1 (k_sys == kp); else #2 sums p
// [N, t_in] bf16 row-major on a 16-byte boundary, t_in a multiple of 4,
// whose tight entry e at the system's K k_sys <= kp lies in row p_rows[e]
// (int32 [k_sys(k_sys+1)/2]; every other row is dropped).  lam [kp, kp],
// prior [kp], noise [items, kp] and out [items, kp] are float32, the
// system padded block-diagonally past k_sys.  cs and cb weigh the rhs (#1:
// cs*(code@v) + cb*(ind@v); #2: code@bf16(bf16(cs) v) + ind@bf16(bf16(cb)
// v)).  The plan: `groups` groups of column units, the frozen axis's
// 64-entry chunks in `segments` runs of `chunks_per_seg` (every run
// non-empty), `smem_bytes` of dynamic shared memory; the entry refuses a
// plan that differs from its layout (ops/dense8.sweep_mma_plan computes
// the same), and one whose groups x segments blocks of an item block do
// not fit the card's SMs at once (they wait for each other).  partial is a
// float32 scratch [segments, items, kp(kp+1)/2 + kp], counters an int32
// [2 + 2 items / 128] that is zero before the launch and left zero after
// it, so launches that share it must be ordered (one stream).  Launches
// on `stream`, returns cudaGetLastError().
extern "C" int bpmf_dense8_sweep_solve_mma(
    const void* codes, int code_bytes, int n_rows, int n_cols, int rows, int kp, int k_sys,
    const void* v_t, const void* p, const void* p_rows, int t_in, const void* lam,
    const void* prior, const void* noise, float cs, float cb, float alpha, int groups,
    int segments, int chunks_per_seg, int smem_bytes, void* partial, void* counters,
    void* out, void* stream) {
  const int items = rows ? n_rows : n_cols;
  const int n_frozen = rows ? n_cols : n_rows;
  const bool hoisted = p != nullptr;
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  if ((kp != 8 && kp != 16 && kp != 24 && kp != 32) || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (items < kItems || items % kItems != 0 || items / kItems > 65535 ||
      n_frozen < kChunk || n_frozen % kChunk != 0 || n_cols % 16 != 0 || !aligned(codes) ||
      !aligned(v_t) || partial == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (hoisted ? (!aligned(p) || p_rows == nullptr || k_sys < 1 || k_sys > kp || t_in < 1 ||
                 t_in % 4 != 0)
              : k_sys != kp)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(hoisted ? t_in : kp * (kp + 1) / 2);
  const Layout ly = layout_of(code_bytes, kp, hoisted, hoisted ? t_in : 0);
  const int n_chunks = n_frozen / kChunk;
  if (groups != pl.groups || smem_bytes != ly.bytes || ly.bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (segments < 1 || pl.groups * segments > sms || chunks_per_seg < 1 ||
      (long long)segments * chunks_per_seg < n_chunks ||
      (long long)(segments - 1) * chunks_per_seg >= n_chunks)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const unsigned char*>(codes), n_cols, items, n_frozen,
               hoisted ? k_sys : kp, static_cast<const uint16_t*>(v_t),
               static_cast<const uint16_t*>(p), static_cast<const int*>(p_rows), t_in,
               static_cast<const float*>(lam), static_cast<const float*>(prior),
               static_cast<const float*>(noise), hoisted ? 1.f : cs, hoisted ? 1.f : cb,
               hoisted ? bf16x2_of(cb) : kOne2, hoisted ? bf16x2_of(cs) : kOne2, alpha, pl,
               ly, n_chunks, chunks_per_seg, static_cast<float*>(partial),
               segments, static_cast<int*>(counters), static_cast<float*>(out)};
  const dim3 grid((unsigned)(pl.groups * segments) * (unsigned)(items / kItems));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return code_bytes == 1 ? dispatch<int8_t>(kp, rows != 0, grid, s, a)
                         : dispatch<int16_t>(kp, rows != 0, grid, s, a);
}
