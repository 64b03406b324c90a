// dense8 half-sweep megakernels for Hopper (sm_90a): the template, built
// once a library per operand type by dense8_sweep_solve.cu (float) and
// dense8_sweep_solve_bf16.cu (bf16 matmul inputs).
//
// Replaces the TPU kernels bpmf_tpu/ops/dense8.py:580 _kernel_fused_solve_inpt
// (#1, launched by _sweep_solve_inpt, dense8.py:639) and :509
// _kernel_fused_solve (#2, launched by dense8_sweep_solve with a p_t, :758):
// for every item of one side, build the Gram and rhs from the rating codes
// (int8, or int16 for 128-255 levels, decoded whole as the TPU kernel's
// codes.astype does) against the frozen side, add the shared prior, factor, solve and
// draw, in one launch:
//
//   G_i = sum_n ind_in v_n v_n',   r_i = sum_n (cs*code_in + cb*ind_in) v_n
//   A_i = lam + alpha*G_i,  L_i L_i' = A_i,
//   u_i = L_i' \ (L_i \ (r_i + prior) + noise_i)
//
// #1 forms the products v_n v_n' in the kernel; #2 reads them from the
// hoisted operand p[n, t] = v_n[ii_t] v_n[jj_t] (packed_tri_t), in the tight
// layout (column j at row j*K - j(j-1)/2) or the 8-aligned one (column j at
// row tri_offsets(K)[j], padding rows below each column holding v_0 v_0).
// Both are one template: they share the code staging, the compaction, the
// segment split, the rhs and the solve, and differ in the Gram's inner loop.
//
// What bounds it on an H100: bytes.  The function must read the code array
// once (25 MB at the padded ml-1m shape, 410 MB for the tall chembl set's
// 800,256 x 512) and the frozen side, and write the draws: 0.01-0.15 ms at
// 3.35 TB/s.  Its f32 FMAs (K^2 per rating, K^3/3 per item) are below that
// line, so the work is latency, not arithmetic.  The arithmetic stays f32
// FMAs: a TF32 tensor-core product would break the 1e-3 agreement with the
// plain version, and 3xTF32 would triple work that is not what sets the
// time.  The TPU kernel multiplies the dense indicator block on the MXU;
// here the work is made proportional to the ratings instead:
//
// * One warp owns one item: lane i keeps row i of the item's Gram in
//   registers, the block stages code tiles of 8 items x 512 frozen entries
//   in shared memory, each warp compacts its item's nonzero codes with
//   ballots and sums only the rated frozen rows.  Two blocks of 8 warps
//   share an SM, so one block's loads overlap the other's solve.
// * The frozen axis is split into S segments (grid = item blocks x S), so
//   the most-rated items (a protein with 294k of 800k compounds rated) are
//   summed by S warps on S SMs and a side with few items still fills the
//   card.  Each block writes its items' partial Gram (the lower triangle,
//   tight order) and rhs to a scratch [S, items, K(K+1)/2 + K], fences, and
//   counts its arrival on a per-item-block counter; the last block to
//   arrive sums the S partials in segment order 0..S-1, resets the counter
//   and solves.  No float atomics: the draws are bitwise reproducible run
//   to run.  At S = 1 there is no scratch and no counter.
// * cp.async keeps copies in flight: the next code tile is copied while
//   this one is compacted and summed, and #1 copies the next 16 rated rows
//   of v into a per-warp ring while its FMAs run on the current 16.
// * #2's lanes own packed entries, not rows: lane l adds entries l, l+32, ...
//   of each rated entry's packed row, so the row is read whole in coalesced
//   loads (float4 in the tight layout; in the aligned one, through a map
//   from valid entry to row computed once, so padding rows are never read).
//   The sums then pass through shared memory (or the scratch) into the
//   row-per-lane layout of the solve.
// * The Gram never leaves the warp for the solve, which is the floor of a
//   side of many lightly rated items (800,256 compounds with 3.2 ratings
//   each): the Cholesky keeps row i on lane i and puts each finished
//   column of L in shared memory, whence the lanes read it four entries
//   a broadcast load instead of a shuffle per entry; the back
//   substitution runs by columns from there, one shuffle and one FMA a
//   step, where a row reduction takes five shuffles; the diagonal's
//   inverse is the pivot's rsqrt, so no step divides; the prior comes
//   from shared memory, and the noise and prior rhs are loaded at the
//   start (past 32 rows after the sums, which need the registers).
// * Past K = 32 (the capacities 40 and 44: K 33-40 and 41, padded) a lane
//   holds two rows, i and i + 32, as the register solve of warp_chol.cuh
//   lays them out: row i's entries 0..31 and row i + 32's entries up to
//   the capacity, 72 or 76 sums a lane, each staged row of v feeding
//   both; that solve (solve_rows_regs) then factors them where they lie.
//   Capacity 48 held 80 sums and spilled more; 40 beside 44 took 10-15%
//   off K=40 (PERF.md §6).
// * #2 at any other K (the JAX package fuses K <= 41 tight, 39 aligned)
//   runs on the next capacity with a runtime K: lane l sums the packed
//   entries 4(l + 32m) .. +3 of the rated rows in the tight order at that
//   K, the tight layout's whole pieces as float4s and its last piece on
//   the lane that owns it, the aligned layout's through a map from entry
//   to row of the operand that the wrapper passes (so its padding rows are
//   never read); entries past K(K+1)/2 read row 0 into sums never written.
//   Each layout has a hit loop of its own and every load of a rating is
//   predicated, never behind a branch, so a rating's loads and the next
//   rating's fly together (behind branches they went one at a time, 10x
//   the time a rating).  The sums go through the work area into the rows of the
//   capacity's solve; rows past K take the padded prior's identity, as
//   #1's do.
//
// bf16 operands (Config.matmul_dtype = "bfloat16"; instances of their own,
// in a library of their own, so that an f32 run never builds them): v and
// p are bf16, everything else f32.  #1 stages the rated rows of v as bf16
// (half the ring's bytes, 8-byte cp.async pieces) and rounds each product
// v_i v_j to bf16 before its f32 add, as the TPU kernel's p = pa * pb in
// bf16 does; its rhs weighs v by cs*code + cb in f32.  #2 reads p as bf16
// (half its bytes) and weighs each rating's v by code*bf16(cs v) +
// bf16(cb v), the TPU kernel's fold (cs and cb rounded to bf16 first, as
// v.dtype.type(cs) does), up to the order of the f32 sums.  Pieces stay 4
// entries (8 bytes), so the lanes' entries, the row map and the alignment
// rules are those of f32.
//
// Instances: the code type (int8_t, int16_t) times the capacity K of one
// warp's lanes (times the operand type, one library each).  #1 is built for K in {8, 16, 24, 32, 40, 44}; the wrapper
// runs a smaller K on the next capacity, its system padded block-
// diagonally (zero frozen columns, identity prior, zero prior rhs and
// noise), so the padded lanes hold exact zeros in every shuffle sum and
// draw u = 0.  #2 is built for K in {16, 32} with its layout's offsets
// fixed at compile time, and for every other K on the same capacities with
// a runtime K.  Shared memory is dynamic (two code stages, the hit lists,
// the prior, the runtime #2's row map, a per-warp work area): 57 KB at
// int8 K=32, 66 KB at int16, 62 and 68 KB at int8 capacity 40 and 44;
// registers (256 threads at up to 128) hold the SM to two blocks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dense8_stage.cuh"  // the code staging, shared with #3
#include "warp_chol.cuh"     // the two-row register solve (past 32)

namespace {

using bpmf::code_at;
using bpmf::cp_async;
using bpmf::cp_async_commit;
using bpmf::cp_async_wait;
using bpmf::gram4;
using bpmf::gram_x;
using bpmf::issue_tile;
using bpmf::kFull;
using bpmf::kItemsPerBlock;
using bpmf::kTile;
using bpmf::ldg1;
using bpmf::ldg4;
using bpmf::load_piece;
using bpmf::round_bf16;
using bpmf::tight_off;
using bpmf::x_float;

// #1; #2 at K 16/32 in the tight or the aligned layout (offsets fixed at
// compile time); #2 at a runtime K in either layout (a row map)
enum class Gram { kInKernel, kTight, kAligned, kPacked };

constexpr int kThreads = bpmf::kStageThreads;
constexpr int kBlocksPerSm = 2;     // one block's loads overlap the other's solve
constexpr int kBatch = 16;          // rated rows of v per cp.async stage (#1)

template <int K>
constexpr int kEntries = K * (K + 1) / 2;  // the lower triangle
template <int K>
constexpr int kPartial = kEntries<K> + K;  // one item's partial: Gram, rhs
template <int K>
constexpr int kGroups = bpmf::kRowGroups<K>;  // rows a lane: 1, or 2 past 32

// Row of column j's first entry (j, j) in the tight packed order.
template <int K>
__host__ __device__ constexpr int tight_offset(int j) {
  return j * K - j * (j - 1) / 2;
}

// The same in #2's operand layout, in closed form so that it folds to a
// constant in the unrolled loops.  Aligned (tri_offsets, K % 8 == 0): each
// column of group g = c/8 takes K - 8g rows, so column j = 8G + r starts
// after G full groups and r columns of its own.
template <int K, Gram G>
__host__ __device__ constexpr int col_offset(int j) {
  static_assert(G != Gram::kAligned || K % 8 == 0,
                "the aligned layout's closed form needs K % 8 == 0");
  if (G != Gram::kAligned) return tight_offset<K>(j);
  const int g = j / 8, r = j % 8;
  return 8 * g * K - 32 * g * (g - 1) + r * (K - 8 * g);
}

// Row stride of the factor's columns in shared memory: a multiple of 4
// for float4 reads of a column.
template <int K>
constexpr int kLStride = K + 4;

// The dynamic shared memory of one instance, in bytes: two code stages,
// the per-warp hit lists, the prior [K][K+1], the runtime #2's row map
// (an int per packed entry), and a per-warp work area (#1: two stages of
// kBatch rows of v; #2: its packed sums; then the factor's columns for
// the solve: [K][K+4] in one row a lane, warp_chol's column store past 32).
// #1's ring holds rows of the operand type V.
template <typename T, typename V, int K, Gram G>
struct Smem {
  static constexpr int kStage = kItemsPerBlock * kTile;  // codes per stage
  static constexpr int kHitsOff = 2 * kStage * (int)sizeof(T);
  static constexpr int kLamOff = kHitsOff + kItemsPerBlock * kTile * 2;
  static constexpr int kGram = G == Gram::kInKernel
                                   ? 2 * kBatch * K * (int)sizeof(V) / 4
                                   : (kEntries<K> + 3) / 4 * 4;
  static constexpr int kSolve = K <= 32 ? K * kLStride<K> : bpmf::lcol_floats(K);
  static constexpr int kWork = kGram > kSolve ? kGram : kSolve;
  static constexpr int kMapOff = kLamOff + 4 * K * (K + 1);
  static constexpr int kWorkOff =
      kMapOff + (G == Gram::kPacked ? 4 * ((kEntries<K> + 3) / 4 * 4) : 0);
  static constexpr int kBytes = kWorkOff + 4 * kItemsPerBlock * kWork;
  static_assert(kLamOff % 16 == 0 && kMapOff % 16 == 0 && kWorkOff % 16 == 0 &&
                    kWork % 4 == 0,
                "16-byte aligned regions");
};

// Component q of a float4, for q fixed at compile time.
__device__ __forceinline__ float& part_of(float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

struct Args {
  const void* codes;
  int n_cols, rows, n_tiles, tiles_per_seg, items;
  const void *v, *p;   // v [n_frozen, K]; p [n_frozen, t_in] (#2): V
  int t_in;
  const int* p_rows;   // runtime #2: the row of p of each packed entry
  int k;               // runtime #2: the system's K (<= the capacity)
  int aligned;         // runtime #2: p in the aligned layout (p_rows read)
  const float *lam, *prior, *noise;  // [K, K], [K], [items, K]
  float cs, cb, alpha;
  float* partial;  // [S, items, kPartial] when S > 1
  int* arrivals;   // [items / kItemsPerBlock], zero between launches (S > 1)
  float* out;      // [items, K]
};

// One block: kItemsPerBlock items (a warp each) over the frozen tiles of
// segment blockIdx.y, then, on the last block of the item block to arrive
// (or at S = 1 on every block), the solve.  K is the capacity: rows
// lane + 32r of an item's system, r < kGroups<K>, on lane `lane`.
template <typename T, typename V, int K, Gram G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sweep_solve_kernel(const Args a) {
  static_assert(K % 4 == 0 && K <= 64, "one warp holds one item's K rows, two a lane");
  constexpr int R = kGroups<K>;
  static_assert(R == 1 || G == Gram::kInKernel || G == Gram::kPacked,
                "past 32 rows: #1 and the runtime #2");
  using L = Smem<T, V, K, G>;
  constexpr bool kInKernel = G == Gram::kInKernel;
  constexpr bool kPacked = G == Gram::kPacked;
  constexpr int kE = kEntries<K>;
  constexpr int kChunks = (kE + 3) / 4;        // #2 tight, runtime: 4-entry pieces
  constexpr int kPer4 = (kChunks + 31) / 32;   // ... per lane
  constexpr int kPer1 = (kE + 31) / 32;        // #2 aligned: entries per lane
  static_assert(G != Gram::kTight || kE % 4 == 0, "whole float4 pieces");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* stage = reinterpret_cast<T*>(smem);
  uint16_t* hits = reinterpret_cast<uint16_t*>(smem + L::kHitsOff) + warp * kTile;
  float* lam_s = reinterpret_cast<float*>(smem + L::kLamOff);
  int* map = reinterpret_cast<int*>(smem + L::kMapOff);  // runtime #2, aligned
  float* work = reinterpret_cast<float*>(smem + L::kWorkOff) + warp * L::kWork;

  const T* codes = static_cast<const T*>(a.codes);
  const V* v = static_cast<const V*>(a.v);
  const V* p = static_cast<const V*>(a.p);
  const int item0 = blockIdx.x * kItemsPerBlock;
  const int item = item0 + warp;
  bool live[R];  // row lane + 32r exists
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = lane + 32 * r < K;
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int t0 = seg * a.tiles_per_seg;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_seg);
  // the solve's own loads, in flight from the start (past 32 rows, after
  // the sums: registers)
  float prior[R], noise[R];
  auto load_vecs = [&] {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      prior[r] = live[r] ? __ldg(a.prior + i) : 0.f;
      noise[r] = live[r] ? __ldg(a.noise + (size_t)item * K + i) : 0.f;
    }
  };
  if constexpr (R == 1) load_vecs();

  // the prior, rows padded to K + 1 so that lane i's reads of row i do not
  // share a bank
  for (int q = threadIdx.x; q < K * K; q += kThreads)
    lam_s[(q / K) * (K + 1) + q % K] = __ldg(a.lam + q);

  float g[R][K];  // #1: rows lane + 32r of the item's Gram, entries < 32(r + 1)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < K && j < 32 * (r + 1); ++j) g[r][j] = 0.f;
  float rhs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rhs[r] = 0.f;
  // #2: packed entries 4(lane + 32m) .. +3 (tight; runtime: in the tight
  // order at K = a.k, the entries below ne), or lane + 32m (aligned: at
  // row_of[m] of p)
  const int ne = kPacked ? a.k * (a.k + 1) / 2 : kE;
  float4 acc4[G == Gram::kTight || kPacked ? kPer4 : 1];
  float acc1[G == Gram::kAligned ? kPer1 : 1];
  int row_of[G == Gram::kAligned ? kPer1 : 1];
  if constexpr (G == Gram::kTight || kPacked) {
#pragma unroll
    for (int m = 0; m < kPer4; ++m) acc4[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (G == Gram::kAligned) {
#pragma unroll
    for (int m = 0; m < kPer1; ++m) {
      const int e = lane + 32 * m;
      int j = 0;
#pragma unroll
      for (int c = 1; c < K; ++c)
        if (e >= tight_offset<K>(c)) j = c;
      row_of[m] = col_offset<K, G>(j) + e - tight_offset<K>(j);
      acc1[m] = 0.f;
    }
  }
  // runtime #2: ne entries in n_pieces pieces of 4, n_whole of them whole;
  // the tight layout's tail piece n_whole (entries ne rounded down to 4 ..
  // ne - 1, past them row 0) summed apart on the lane that owns it
  const int n_pieces = (ne + 3) / 4, n_whole = ne / 4;
  const bool tail_lane = kPacked && !a.aligned && ne % 4 && lane == n_whole % 32;
  int tail_at[3];
  float tail[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    tail_at[q] = 4 * n_whole + q < ne ? 4 * n_whole + q : 0;
    tail[q] = 0.f;
  }
  if constexpr (kPacked) {
    // the aligned layout's row of each packed entry, for the block (the
    // tile loop's first barrier orders it before any read)
    if (a.aligned)
      for (int e = threadIdx.x; e < 4 * kChunks; e += kThreads)
        map[e] = e < ne ? __ldg(a.p_rows + e) : 0;
  }

  issue_tile(stage, codes, a.rows, a.n_cols, item0, t0 * kTile);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    const T* tile = stage + buf * L::kStage;
    __syncthreads();  // every warp is done with the other stage and its hits
    if (t + 1 < t1)
      issue_tile(stage + (buf ^ 1) * L::kStage, codes, a.rows, a.n_cols, item0,
                 (t + 1) * kTile);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may fly)
    __syncthreads();
    const int n0 = t * kTile;

    // compact this item's rated entries of the tile
    int count = 0;
    for (int q = 0; q < kTile; q += 32) {
      const T c = code_at(tile, a.rows, warp, q + lane);
      const unsigned m = __ballot_sync(kFull, c != 0);
      if (c != 0) hits[count + __popc(m & ((1u << lane) - 1u))] = (uint16_t)(q + lane);
      count += __popc(m);
    }
    __syncwarp();

    if constexpr (kInKernel) {
      // rated rows of v through a two-stage ring: batch b + 1 is copied
      // while the FMAs run on batch b
      constexpr int kPieces = K / 4;  // 4-entry pieces per row
      V* ring = reinterpret_cast<V*>(work);
      auto issue_rows = [&](int b, int sb) {
        const int nb = min(kBatch, count - b);
        V* dst = ring + sb * kBatch * K;
        for (int c = lane; c < nb * kPieces; c += 32) {
          const int s = c / kPieces, piece = c % kPieces;
          cp_async<bpmf::kPieceBytes<V>>(dst + s * K + 4 * piece,
                                   v + (size_t)(n0 + hits[b + s]) * K + 4 * piece);
        }
      };
      if (count > 0) {
        issue_rows(0, 0);
        cp_async_commit();
      }
      int sb = 0;
      for (int b = 0; b < count; b += kBatch, sb ^= 1) {
        if (b + kBatch < count) {
          issue_rows(b + kBatch, sb ^ 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const V* rb = ring + sb * kBatch * K;
        const int nb = min(kBatch, count - b);
#pragma unroll (R == 1 ? 4 : 2)
        for (int s = 0; s < nb; ++s) {
          const V* row = rb + s * K;
          using X = decltype(gram_x(row));
          X x[R];
#pragma unroll
          for (int r = 0; r < R; ++r) x[r] = live[r] ? gram_x(row + lane + 32 * r) : X(0);
          const float w = fmaf(a.cs, (float)code_at(tile, a.rows, warp, hits[b + s]),
                               a.cb);
#pragma unroll
          for (int r = 0; r < R; ++r) rhs[r] = fmaf(w, x_float(x[r]), rhs[r]);
#pragma unroll
          for (int j4 = 0; j4 < K / 4; ++j4) {
            const auto q = load_piece(row + 4 * j4);
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (4 * j4 < 32 * (r + 1)) gram4(x[r], q, &g[r][4 * j4]);
          }
        }
        __syncwarp();  // the stage is free for the copy after next
      }
    } else {
      // #2: each rated entry's rhs term, and its packed row (a row of p)
      // summed into this lane's entries; bf16: the fold's weights
      // code*bf16(cs v) + bf16(cb v), cs and cb rounded to bf16
      const float cs_b = round_bf16(a.cs), cb_b = round_bf16(a.cb);
      auto add_rhs = [&](int nl) {
        const size_t n = (size_t)(n0 + nl);
        const float code = (float)code_at(tile, a.rows, warp, nl);
        const float w = fmaf(a.cs, code, a.cb);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = live[r] ? ldg1(v + n * K + lane + 32 * r) : 0.f;
          if constexpr (bpmf::kBf16<V>)
            rhs[r] += fmaf(code, round_bf16(cs_b * x), round_bf16(cb_b * x));
          else
            rhs[r] = fmaf(w, x, rhs[r]);
        }
        return p + n * a.t_in;
      };
      if constexpr (G == Gram::kTight) {
#pragma unroll 2
        for (int h = 0; h < count; ++h) {
          const V* row = add_rhs(hits[h]);
#pragma unroll
          for (int m = 0; m < kPer4; ++m) {
            const int c = lane + 32 * m;
            if (m < kPer4 - 1 || c < kChunks) {
              const float4 q = ldg4(row + 4 * c);
              acc4[m].x += q.x;
              acc4[m].y += q.y;
              acc4[m].z += q.z;
              acc4[m].w += q.w;
            }
          }
        }
      } else if constexpr (G == Gram::kAligned) {
#pragma unroll 2
        for (int h = 0; h < count; ++h) {
          const V* row = add_rhs(hits[h]);
#pragma unroll
          for (int m = 0; m < kPer1; ++m)
            if (m < kPer1 - 1 || lane + 32 * m < kE) acc1[m] += ldg1(row + row_of[m]);
        }
      } else if (a.aligned) {
        // runtime K, aligned: the pieces through the block's row map
        const int4* map4 = reinterpret_cast<const int4*>(map);
#pragma unroll 2
        for (int h = 0; h < count; ++h) {
          const V* row = add_rhs(hits[h]);
#pragma unroll
          for (int m = 0; m < kPer4; ++m) {
            const int c = lane + 32 * m;
            if (32 * m < kChunks && c < n_pieces) {
              const int4 at = map4[c];
              acc4[m].x += ldg1(row + at.x);
              acc4[m].y += ldg1(row + at.y);
              acc4[m].z += ldg1(row + at.z);
              acc4[m].w += ldg1(row + at.w);
            }
          }
        }
      } else {
        // runtime K, tight: whole pieces as float4s, the tail piece (1-3
        // entries) on the lane that owns it
#pragma unroll 2
        for (int h = 0; h < count; ++h) {
          const V* row = add_rhs(hits[h]);
#pragma unroll
          for (int m = 0; m < kPer4; ++m) {
            const int c = lane + 32 * m;
            if (32 * m < kChunks && c < n_whole) {
              const float4 q = ldg4(row + 4 * c);
              acc4[m].x += q.x;
              acc4[m].y += q.y;
              acc4[m].z += q.z;
              acc4[m].w += q.w;
            }
          }
#pragma unroll
          for (int q = 0; q < 3; ++q)
            tail[q] += tail_lane ? ldg1(row + tail_at[q]) : 0.f;
        }
      }
    }
  }

  if (tail_lane) {
#pragma unroll
    for (int m = 0; m < kPer4; ++m)
      if (m == n_whole / 32) {
        acc4[m].x += tail[0];
        acc4[m].y += tail[1];
        acc4[m].z += tail[2];
      }
  }

  // this segment's sums: to the scratch when S > 1; #2's packed sums
  // through shared memory into row-per-lane at S = 1
  const bool split = n_seg > 1;
  float* part = split ? a.partial + ((size_t)seg * a.items + item) * kPartial<K>
                      : nullptr;
  if constexpr (G == Gram::kTight || G == Gram::kAligned) {
    float* dst = split ? part : work;
    if constexpr (G == Gram::kTight) {
#pragma unroll
      for (int m = 0; m < kPer4; ++m) {
        const int c = lane + 32 * m;
        if (m < kPer4 - 1 || c < kChunks) reinterpret_cast<float4*>(dst)[c] = acc4[m];
      }
    } else {
#pragma unroll
      for (int m = 0; m < kPer1; ++m)
        if (m < kPer1 - 1 || lane + 32 * m < kE) dst[lane + 32 * m] = acc1[m];
    }
    if (!split) {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < K; ++j)
        g[0][j] = (live[0] && lane >= j) ? work[tight_offset<K>(j) + lane - j] : 0.f;
    }
  } else if constexpr (kPacked) {
    if (split) {
#pragma unroll
      for (int m = 0; m < kPer4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * (lane + 32 * m) + q;
          if (32 * m < kChunks && e < ne) part[e] = part_of(acc4[m], q);
        }
    }
  } else if (split) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < K && j < 32 * (r + 1); ++j) {
        const int i = lane + 32 * r;
        if (live[r] && i >= j) part[tight_offset<K>(j) + i - j] = g[r][j];
      }
  }

  if (split) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (live[r]) part[kE + lane + 32 * r] = rhs[r];
    __threadfence();  // this block's partials before its arrival
    __syncthreads();
    if (threadIdx.x == 0) {
      const int prev = atomicAdd(a.arrivals + blockIdx.x, 1);
      last_block = prev == n_seg - 1;
      if (last_block) a.arrivals[blockIdx.x] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    // the S partials, in segment order whichever block arrives last, read
    // through L2 (other SMs wrote them)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rhs[r] = 0.f;
#pragma unroll
      for (int j = 0; j < K && j < 32 * (r + 1); ++j) g[r][j] = 0.f;
    }
    if constexpr (kPacked) {
#pragma unroll
      for (int m = 0; m < kPer4; ++m) acc4[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s = 0; s < n_seg; ++s) {
      const float* src = a.partial + ((size_t)s * a.items + item) * kPartial<K>;
      if constexpr (kPacked) {
#pragma unroll
        for (int m = 0; m < kPer4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * (lane + 32 * m) + q;
            if (32 * m < kChunks && e < ne) part_of(acc4[m], q) += __ldcg(src + e);
          }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < K && j < 32 * (r + 1); ++j) {
            const int i = lane + 32 * r;
            if (live[r] && i >= j) g[r][j] += __ldcg(src + tight_offset<K>(j) + i - j);
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r]) rhs[r] += __ldcg(src + kE + lane + 32 * r);
    }
  }
  if constexpr (kPacked) {
    // the packed sums, tight at K = a.k, through the work area into rows;
    // rows past a.k stay zero (the padded prior's identity)
#pragma unroll
    for (int m = 0; m < kPer4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * (lane + 32 * m) + q;
        if (32 * m < kChunks && e < ne) work[e] = part_of(acc4[m], q);
      }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < K && j < 32 * (r + 1); ++j) {
        const int i = lane + 32 * r;
        g[r][j] = (i < a.k && i >= j) ? work[tight_off(j, a.k) + i - j] : 0.f;
      }
  }
  __syncthreads();  // lam_s; every lane is done with its work area

  if constexpr (R > 1) load_vecs();
  // A = lam + alpha*G; lane i holds row i (and row i + 32 past 32).  Only
  // the lower triangle is read below, as in the TPU kernel; idle rows
  // (i >= K) never feed a shuffle.
  float y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
#pragma unroll
    for (int j = 0; j < K && j < 32 * (r + 1); ++j)
      g[r][j] = live[r] ? fmaf(a.alpha, g[r][j], lam_s[i * (K + 1) + j]) : 0.f;
    y[r] = live[r] ? rhs[r] + prior[r] : 0.f;
  }

  if constexpr (R > 1) {
    // two rows a lane: warp_chol's register solve, where the rows lie
    bpmf::solve_rows_regs<K>(g, y, noise, work, K, a.out + (size_t)item * K);
    return;
  } else {
    // right-looking Cholesky: after step j, lane i > j holds L_ij in g[j],
    // lane j holds L_jj and its inverse, and column j of L lies in shared
    // memory (lcol[j][i] = L_ij), whence every lane reads it by broadcast,
    // four entries a load, for its update
    const bool on = live[0];
    float* lcol = work;
    float inv = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = rsqrtf(__shfl_sync(kFull, g[0][j], j));
      const float lij = g[0][j] * d;
      if (lane == j) inv = d;
      g[0][j] = lij;
      if (on) lcol[j * kLStride<K> + lane] = lij;
      __syncwarp();
#pragma unroll
      for (int k4 = (j + 1) / 4; k4 < K / 4; ++k4) {
        const float4 c = reinterpret_cast<const float4*>(lcol + j * kLStride<K>)[k4];
        if (4 * k4 + 0 > j) g[0][4 * k4 + 0] = fmaf(-lij, c.x, g[0][4 * k4 + 0]);
        if (4 * k4 + 1 > j) g[0][4 * k4 + 1] = fmaf(-lij, c.y, g[0][4 * k4 + 1]);
        if (4 * k4 + 2 > j) g[0][4 * k4 + 2] = fmaf(-lij, c.z, g[0][4 * k4 + 2]);
        if (4 * k4 + 3 > j) g[0][4 * k4 + 3] = fmaf(-lij, c.w, g[0][4 * k4 + 3]);
      }
    }

    // forward substitution L z = y (row j of L on lane j's registers)
    float z = y[0];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (lane == j) z *= inv;
      const float zj = __shfl_sync(kFull, z, j);
      if (lane > j) z = fmaf(-g[0][j], zj, z);
    }
    z += noise[0];

    // back substitution L' u = z by columns: u_j = z_j / L_jj, then every
    // lane i < j takes L_ji u_j off z_i, L_ji read from column i
    float u = 0.f;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      if (lane == j) u = z * inv;
      const float uj = __shfl_sync(kFull, u, j);
      if (lane < j) z = fmaf(-lcol[lane * kLStride<K> + j], uj, z);
    }
    if (on) a.out[(size_t)item * K + lane] = u;
  }
}

template <typename T, typename V, int K, Gram G>
int launch(dim3 grid, cudaStream_t s, const Args& a) {
  int rows = 0;  // of p that the instance reads (#2 with fixed offsets)
  if constexpr (G == Gram::kTight) rows = (K * (K + 1) / 2 + 15) / 16 * 16;
  if constexpr (G == Gram::kAligned) rows = col_offset<K, Gram::kAligned>(K);
  if (a.t_in < rows || a.t_in % 4 != 0) return (int)cudaErrorInvalidValue;
  if (G == Gram::kPacked && (a.p_rows == nullptr || a.k < 1 || a.k > K || a.t_in < 1))
    return (int)cudaErrorInvalidValue;
  constexpr int kBytes = Smem<T, V, K, G>::kBytes;
  // above 48 KB only after the attribute is raised (once per instance and
  // device); otherwise the launch is refused and only its return code says so
  static int configured = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured != dev) {
    err = cudaFuncSetAttribute(sweep_solve_kernel<T, V, K, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = dev;
  }
  sweep_solve_kernel<T, V, K, G><<<grid, kThreads, kBytes, s>>>(a);
  return (int)cudaGetLastError();
}

// One Gram variant on the capacities it is built for: #1 and the runtime
// #2 on 8, 16, 24, 32, 40 and 44, #2 with fixed offsets at K 16 and 32
template <typename T, typename V, Gram G>
int by_capacity(int k, dim3 grid, cudaStream_t s, const Args& a) {
  constexpr bool kAny = G == Gram::kInKernel || G == Gram::kPacked;
  switch (k) {
    case 16: return launch<T, V, 16, G>(grid, s, a);
    case 32: return launch<T, V, 32, G>(grid, s, a);
    default: break;
  }
  if constexpr (kAny) {
    switch (k) {
      case 8: return launch<T, V, 8, G>(grid, s, a);
      case 24: return launch<T, V, 24, G>(grid, s, a);
      case 40: return launch<T, V, 40, G>(grid, s, a);
      case 44: return launch<T, V, 44, G>(grid, s, a);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename V>
int dispatch(int k, Gram g, dim3 grid, cudaStream_t s, const Args& a) {
  switch (g) {
    case Gram::kInKernel: return by_capacity<T, V, Gram::kInKernel>(k, grid, s, a);
    case Gram::kTight: return by_capacity<T, V, Gram::kTight>(k, grid, s, a);
    case Gram::kAligned: return by_capacity<T, V, Gram::kAligned>(k, grid, s, a);
    default: return by_capacity<T, V, Gram::kPacked>(k, grid, s, a);
  }
}

// The library's C entry point for operand type V (float: dense8_sweep_
// solve.cu, bf16: dense8_sweep_solve_bf16.cu).  codes is [n_rows, n_cols],
// row-major, 16-byte aligned, of code_bytes bytes each (1: int8, 2: int16);
// rows != 0 makes the code rows the items (frozen axis = columns), rows == 0
// the code columns.  Both dimensions must be multiples of 512; v and p
// start on 16-byte boundaries, as the allocator's tensors do.  k is the
// instance's capacity: 8, 16, 24, 32, 40 or 44 for #1 and the runtime #2, 16
// or 32 for #2 with fixed offsets.  p == null selects #1; otherwise p is
// the hoisted operand [N, t_in], row-major (N = the frozen count), t_in a
// multiple of 4.  With p_rows == null it is read in the aligned layout when
// aligned != 0, else the tight one, at K = k (#2 with fixed offsets);
// otherwise the system's K is k_p <= k and p_rows an int32 [k_p(k_p+1)/2]
// giving the row of p of each packed entry, in the tight order (column j
// from entry j*k_p - j(j-1)/2).  v and p are of type V; v, lam, prior,
// noise and out have k columns, the system padded block-diagonally past
// its K; lam, prior, noise and out are float32.  The frozen axis's
// 512-entry tiles are split into `segments` runs of `tiles_per_seg` (every
// run non-empty); with more than one, `partial` is a float32 scratch
// [segments, items, k(k+1)/2 + k] and `arrivals` an int32 [items / 8] that
// is zero before the launch and is left zero after it, so launches that
// share it must be ordered (one stream).  Launches on `stream` and returns
// cudaGetLastError().
template <typename V>
int sweep_solve_entry(const void* codes, int code_bytes, int n_rows, int n_cols,
                      int rows, int k, const void* v, const void* p,
                      const void* p_rows, int t_in, int aligned, int k_p,
                      const void* lam, const void* prior, const void* noise,
                      float cs, float cb, float alpha, int segments,
                      int tiles_per_seg, void* partial, void* arrivals,
                      void* out, void* stream) {
  const int items = rows ? n_rows : n_cols;
  const int n_frozen = rows ? n_cols : n_rows;
  const int n_tiles = n_frozen / kTile;
  // every staged copy starts on a boundary of its size: the array's base
  // (16 bytes), and item0 * code_bytes (item0 a multiple of 8) in rows of
  // n_cols codes; v's rows and p's are read in 4-entry pieces
  if (items % kItemsPerBlock != 0 || n_frozen % kTile != 0 ||
      n_cols % kItemsPerBlock != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (segments < 1 || segments > 65535 || tiles_per_seg < 1 ||
      (long long)segments * tiles_per_seg < n_tiles ||
      (long long)(segments - 1) * tiles_per_seg >= n_tiles ||
      (segments > 1 && (partial == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(items / kItemsPerBlock, segments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{codes, n_cols, rows, n_tiles, tiles_per_seg, items, v, p,
               t_in, static_cast<const int*>(p_rows), k_p, aligned,
               static_cast<const float*>(lam),
               static_cast<const float*>(prior),
               static_cast<const float*>(noise), cs, cb, alpha,
               static_cast<float*>(partial), static_cast<int*>(arrivals),
               static_cast<float*>(out)};
  const Gram g = p == nullptr ? Gram::kInKernel
                 : p_rows != nullptr ? Gram::kPacked
                 : aligned ? Gram::kAligned
                           : Gram::kTight;
  switch (code_bytes) {
    case 1: return dispatch<int8_t, V>(k, g, grid, s, a);
    case 2: return dispatch<int16_t, V>(k, g, grid, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry point's parameters, for the thin files that instantiate it.
#define BPMF_SWEEP_SOLVE_PARAMS                                                \
  const void *codes, int code_bytes, int n_rows, int n_cols, int rows, int k, \
      const void *v, const void *p, const void *p_rows, int t_in, int aligned, \
      int k_p, const void *lam, const void *prior, const void *noise,         \
      float cs, float cb, float alpha, int segments, int tiles_per_seg,      \
      void *partial, void *arrivals, void *out, void *stream
#define BPMF_SWEEP_SOLVE_ARGS                                                  \
  codes, code_bytes, n_rows, n_cols, rows, k, v, p, p_rows, t_in, aligned,   \
      k_p, lam, prior, noise, cs, cb, alpha, segments, tiles_per_seg,        \
      partial, arrivals, out, stream
