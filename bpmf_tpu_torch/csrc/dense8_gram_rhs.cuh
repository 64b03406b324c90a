// dense8 Gram and rhs for Hopper (sm_90a): the first stage of the split
// pipeline on float32 operands, built by dense8_gram_rhs.cu.  On bf16
// operands (Config.matmul_dtype = "bfloat16") the same function runs on the
// tensor cores instead, dense over the code tiles: dense8_gram_mma.cu.
//
// Replaces the TPU kernels bpmf_tpu/ops/dense8.py:233 _kernel_inpt (packed
// products built in the kernel, launched at :287) and :339 _kernel (packed
// products streamed from a hoisted operand p_t, launched at :415).  For
// every item i of one side, over the rated entries n of its code row (or
// column) of int8 codes, or of int16 codes for 128-255 rating levels (both
// decoded whole, as the TPU kernels' codes.astype does; one template each):
//
//   gram_i[t] = sum_n p[n, t]                  t over the packed triangle
//   rhs_i     = sum_n (cs*code_in + cb) * v_n
//
// where p[n, t] = v[n, ii_t] * v[n, jj_t] in the tight layout
// (tri_tight_pairs), formed here from v (in-kernel) or read from the
// caller's p (hoisted).  The TPU kernel's fold (the cb-term riding the Gram
// as K extra rows, saving an MXU pass) is not needed: both forms weigh each
// rating by cs*code + cb as they compact it.  Outputs are item-major
// ([items, T] and [items, K]); #3 zeroes the Gram's rows past K(K+1)/2, #4
// sums every row of p, its padding rows too, as the TPU kernel does.
//
// In-kernel (#3).  What bounds it on an H100: the f32 FMAs of the rated
// entries, K(K+1)/2 + K per rating (2144 at K=64), and the latency of the
// most-rated item's chain of them; the code stream is small and mostly
// zero (about 4% of the padded ml-1m codes are ratings).  The TPU kernel
// multiplies the dense indicator block on the MXU; here the work is made
// proportional to the ratings, on the megakernel's plan
// (dense8_sweep_solve.cu):
//
// * A block owns 8 items, a warp each, so light items share a block and
//   none pays a block-wide barrier per scan step.  The block's codes are
//   staged in tiles of 8 items x 512 frozen entries with 16-byte cp.async
//   copies, double-buffered (dense8_stage.cuh, shared with #1: in the
//   column orientation each frozen row gives the block's 8 codes in one
//   copy).  Each warp compacts its item's nonzero codes with ballots, in
//   order, and copies the rated rows of v, 16 at a time, into a per-warp
//   ring with cp.async while its FMAs run on the previous 16.
// * K <= 64 (instances of capacity 16, 32, 48, 64): the item's Gram rows
//   in registers, as the megakernel forms its Gram: lane i % 32 holds row
//   i, up to two rows a lane (columns 0..31 of the first, 0..63 of the
//   second: 96 accumulators at K=64).  A staged row gives the lane its own
//   entries by scalar reads and every column by float4 broadcast, one
//   shared-memory wavefront each, and the lane's rows are written to the
//   packed layout with the lanes on consecutive rows (coalesced).  Two
//   blocks an SM.  K 65-79: the lanes own 4x4 tiles of the lower triangle
//   (7 tiles a lane, 16 accumulators each), each fed by two float4 reads.
//   The products stay f32 FMAs: a TF32 tensor-core product would break the
//   1e-3 agreement with the plain version.
// * The frozen axis is split into S segments (grid = item blocks x S,
//   ops/dense8.sweep_plan), so the most-rated item (a protein with tens of
//   thousands of compounds) is summed on S SMs.  Each segment writes its
//   partial Gram and rhs to a scratch [S, items, K(K+1)/2 + K] and counts
//   its arrival on an int32 counter per item block; the last block sums
//   the S partials in segment order 0..S-1 and resets the counter.  No
//   float atomics: repeated launches are bitwise equal.
//
// Known limits: v's rows are zero-padded to the instance's width (the
// wrapper does it), and the lanes compute the upper half of the diagonal
// 32x32 blocks, which is never written (68% of the FMAs are needed at
// K=64); the last block of an item block sums all S partials alone; the
// uniform S scratch is written for light items too.
//
// Hoisted (#4).  What bounds it on an H100: the bytes of the rated rows of
// p, one packed row (T floats, 8.3 KB at K=64) per rating, which no other
// item of the block reuses: 8.4 GB at [6144, 4096], 4% rated, K=64, many
// times p itself.  They come from L2 only where the rows that the blocks
// in flight read fit in it, and then at L2's read bandwidth.  On light
// items the Gram write (items x T floats, 1.39 GB on chembl's 167k
// compounds at K=64) bounds it instead.  Design, on #3's plan:
//
// * 8 items a block, a warp each; the code tiles staged and compacted as
//   above (no block-wide barrier per scan step, no list to flush).
// * Each lane owns T/128 float4 sums of the item's packed Gram in
//   registers (instances of 2, 5, 10, 17 and 26 float4s: t_out up to 256,
//   640, 1280, 2176 and 3328; 17 at K=64; 26 at K=79, one block an SM, no
//   spill to shared memory).  Each rated row of p is read whole as
//   coalesced float4 loads, all of a row in flight at once, by every warp
//   of the SM; the rhs is K f32 FMAs a rating on v's row, lanes over k.
// * The frozen axis is split into S segments (grid = item blocks x S, the
//   segment the slow dimension; ops/dense8.hoisted_plan): the segments
//   whose blocks run at once read at most 40 MB of p's rows, which stay
//   in L2, and the most-rated item is summed on S SMs, at most 512 of its
//   ratings a segment (its warp, one row in flight at a time, is the
//   launch's longest chain).  The partials and the ordered last-block sum
//   are #3's (no float atomics, launches bitwise equal).  The wrapper
//   passes p as it lies: the item-major rows that ops/dense8.packed_tri_t
//   builds are the transposed view the kernel reads, so no launch copies
//   it.
//
// Known limits: a rated row is read by one warp, so two items of a block
// that rate the same frozen entry read its row twice, and the bytes from
// L2 stay one row a rating.  Blocks of 64 items that list the entries any
// of them rated and bring each listed row through a shared-memory ring
// once (2.8x fewer bytes at 4% density) were tried and were slower here:
// one such block fills an SM, and its tile staging, listing and ring
// barriers alone took about as long as this kernel.  The partials of
// S > 1 are a round trip through HBM (S x items x T floats).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dense8_stage.cuh"  // the code staging, shared with #1

namespace {

using bpmf::code_at;
using bpmf::cp_async;
using bpmf::cp_async_commit;
using bpmf::cp_async_wait;
using bpmf::gram4;
using bpmf::issue_tile;
using bpmf::kFull;
using bpmf::kItemsPerBlock;
using bpmf::kTile;
using bpmf::ldg1;
using bpmf::ldg4;
using bpmf::load_piece;
using bpmf::piece_xs;

constexpr int kMaxK = 80;      // the dense8 gate admits K <= 79
constexpr int kThreads = bpmf::kStageThreads;
constexpr int kBatch = 16;     // rated rows of v per cp.async stage (#3)
constexpr int kHoistMaxVec = 26;  // #4: float4 sums a lane, t_out <= 3328

// -- #3: in-kernel products ------------------------------------------------

struct GramArgs {
  const void* codes;
  int n_cols, rows, n_tiles, tiles_per_seg, items, k;
  const void* v;   // [n_frozen, kv] of the operand type, rows zero-padded
                   // to kv = roundup(k, 4)
  int kv;
  float cs, cb;
  int t_out;
  float* partial;  // [S, items, k(k+1)/2 + k] when S > 1
  int* arrivals;   // [items / 8], zero between launches (S > 1)
  float* gram;     // [items, t_out]
  float* rhs;      // [items, k]
};

// Dynamic shared memory of #3: two code stages, the per-warp hit lists,
// the per-warp rings of v rows.
template <typename T>
struct GramSmem {
  static constexpr int kStage = kItemsPerBlock * kTile;  // codes per stage
  static constexpr int kHitsOff = 2 * kStage * (int)sizeof(T);
  static constexpr int kRingOff = kHitsOff + kItemsPerBlock * kTile * 2;
  static_assert(kRingOff % 16 == 0, "16-byte aligned rings");
  static constexpr size_t bytes(int kv) {
    return kRingOff + sizeof(float) * kItemsPerBlock * 2 * kBatch * kv;
  }
};

__device__ __forceinline__ int tight_row(int i, int j, int k) {
  return j * k - j * (j - 1) / 2 + i - j;
}

// The tile loop of one block (8 items, a warp each) over the frozen tiles
// of segment blockIdx.y: stage each tile's codes, compact each warp's
// rated entries in order, bring their rows of v through the warp's ring,
// and hand each staged row and its rhs weight to on_row(row, w), in the
// order of the frozen axis.
template <typename T, typename OnRow>
__device__ __forceinline__ void for_rated_rows(const GramArgs& a, OnRow& on_row) {
  using L = GramSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv = a.kv;
  T* stage = reinterpret_cast<T*>(smem);
  uint16_t* hits = reinterpret_cast<uint16_t*>(smem + L::kHitsOff) + warp * kTile;
  float* ring = reinterpret_cast<float*>(smem + L::kRingOff) + warp * 2 * kBatch * kv;
  const T* codes = static_cast<const T*>(a.codes);
  const float* v = static_cast<const float*>(a.v);
  const int item0 = blockIdx.x * kItemsPerBlock;
  const int t0 = blockIdx.y * a.tiles_per_seg;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_seg);

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

    // compact this item's rated entries of the tile, in order
    int count = 0;
    for (int q = 0; q < kTile; q += 32) {
      const T c = code_at(tile, a.rows, warp, q + lane);
      const unsigned m = __ballot_sync(kFull, c != 0);
      if (c != 0) hits[count + __popc(m & ((1u << lane) - 1u))] = (uint16_t)(q + lane);
      count += __popc(m);
    }
    __syncwarp();

    // rated rows of v through a two-stage ring: batch b + 1 is copied
    // while the FMAs run on batch b
    const int pieces = kv / 4;  // 4-entry pieces per row
    auto issue_rows = [&](int b, int sb) {
      const int nb = min(kBatch, count - b);
      float* dst = ring + sb * kBatch * kv;
      for (int c = lane; c < nb * pieces; c += 32) {
        const int s = c / pieces, piece = c - s * pieces;
        cp_async<16>(dst + s * kv + 4 * piece,
                     v + (size_t)(n0 + hits[b + s]) * kv + 4 * piece);
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
      const float* rb = ring + sb * kBatch * kv;
      const int nb = min(kBatch, count - b);
      for (int s = 0; s < nb; ++s)
        on_row(rb + s * kv,
               fmaf(a.cs, (float)code_at(tile, a.rows, warp, hits[b + s]), a.cb));
      __syncwarp();  // the stage is free for the copy after next
    }
  }
}

// Where this block's sums of its item go: the scratch at S > 1, else the
// outputs.  (gram, rhs) pointers of the item.
__device__ __forceinline__ float* segment_gram(const GramArgs& a, int item) {
  const int tv = a.k * (a.k + 1) / 2;
  return gridDim.y > 1
             ? a.partial + ((size_t)blockIdx.y * a.items + item) * (tv + a.k)
             : a.gram + (size_t)item * a.t_out;
}

__device__ __forceinline__ float* segment_rhs(const GramArgs& a, int item) {
  const int tv = a.k * (a.k + 1) / 2;
  return gridDim.y > 1 ? segment_gram(a, item) + tv : a.rhs + (size_t)item * a.k;
}

// At S > 1, once the block's partials are written: counts the block's
// arrival on its item block's counter and returns, uniformly over the
// block, whether it is the last of the S segments (then with the others'
// partials visible, and the counter reset for the next launch).
__device__ __forceinline__ bool last_arrival(int* arrivals) {
  __shared__ int last_block;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(arrivals + blockIdx.x, 1);
    last_block = prev == (int)gridDim.y - 1;
    if (last_block) arrivals[blockIdx.x] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return false;
  __threadfence();
  return true;
}

// After the block's sums are written: at S > 1 the last block of the item
// block sums the S partials in segment order 0..S-1 (lanes over the packed
// entries).  Then the rows past K(K+1)/2 are zeroed.
__device__ __forceinline__ void finish(const GramArgs& a, int item) {
  const int lane = threadIdx.x & 31;
  const int k = a.k, tv = k * (k + 1) / 2, n_seg = gridDim.y;
  float* g = a.gram + (size_t)item * a.t_out;
  if (n_seg > 1) {
    if (!last_arrival(a.arrivals)) return;
    // read through L2: other SMs wrote them
    for (int e = lane; e < tv + k; e += 32) {
      float sum = 0.f;
      for (int s = 0; s < n_seg; ++s)
        sum += __ldcg(a.partial + ((size_t)s * a.items + item) * (tv + k) + e);
      if (e < tv) g[e] = sum;
      else a.rhs[(size_t)item * k + e - tv] = sum;
    }
  }
  for (int e = tv + lane; e < a.t_out; e += 32) g[e] = 0.f;
}

// K <= KP <= 64: rows lane and lane + 32 of the item's Gram in registers
// (group r holds row lane + 32r, columns 0 .. min(KP, 32(r+1)) - 1), as the
// megakernel forms its Gram: each staged row gives the lane its own
// entries by two scalar reads and every column by 4-entry broadcasts.  v's
// rows are KP entries, zero past K.
template <int KP>
struct RowSums {
  static constexpr int R = (KP + 31) / 32;
  float g[R][KP], r[R];
  int lane;
  __device__ __forceinline__ void operator()(const float* row, float w) {
    float x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      x[q] = lane + 32 * q < KP ? row[lane + 32 * q] : 0.f;
      r[q] = fmaf(w, x[q], r[q]);
    }
#pragma unroll
    for (int j4 = 0; j4 < KP / 4; ++j4) {
      const auto c = load_piece(row + 4 * j4);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (4 * j4 < 32 * (q + 1)) gram4(x[q], c, &g[q][4 * j4]);
    }
  }
};

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads, 2)
gram_rhs_rows(const GramArgs a) {
  constexpr int R = RowSums<KP>::R;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kItemsPerBlock + (threadIdx.x >> 5);
  RowSums<KP> acc;
  acc.lane = lane;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    acc.r[q] = 0.f;
#pragma unroll
    for (int j = 0; j < KP; ++j) acc.g[q][j] = 0.f;
  }
  for_rated_rows<T>(a, acc);
  const int k = a.k;
  float* dst = segment_gram(a, item);
  float* rdst = segment_rhs(a, item);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i >= k) continue;
#pragma unroll
    for (int j = 0; j < KP && j < 32 * (q + 1); ++j)
      if (j <= i) dst[tight_row(i, j, k)] = acc.g[q][j];  // lanes on consecutive rows
    rdst[i] = acc.r[q];
  }
  finish(a, item);
}

// 64 < K <= 79: the lanes own 4x4 tiles of the lower triangle (M tiles a
// lane, 16 accumulators each): each staged row feeds a tile's 16 FMAs from
// two 4-entry reads.  v's rows are roundup(K, 4) entries, zero past K.
template <int M>
struct TileSums {
  float acc[M][16];
  float r[3];  // rhs entries lane, lane + 32, lane + 64
  int xo[M], yo[M];
  bool tile_live[M];
  int lane, k;
  __device__ __forceinline__ void operator()(const float* row, float w) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (lane + 32 * q < k) r[q] = fmaf(w, row[lane + 32 * q], r[q]);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!tile_live[m]) continue;
      const auto y = load_piece(row + 4 * yo[m]);
      float xs[4];
      piece_xs(load_piece(row + 4 * xo[m]), xs);
#pragma unroll
      for (int p = 0; p < 4; ++p) gram4(xs[p], y, &acc[m][4 * p]);
    }
  }
};

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
gram_rhs_tiles(const GramArgs a) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kItemsPerBlock + (threadIdx.x >> 5);
  const int k = a.k;
  TileSums<M> t;
  t.lane = lane;
  t.k = k;
  // slot m is tile s = lane + 32m of the lower triangle of 4x4 tiles (row
  // block ta >= column block tb), if s < n_tiles
  const int tps = a.kv / 4;
  const int n_tiles = tps * (tps + 1) / 2;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    int ta = 0, tb = lane + 32 * m;
    t.tile_live[m] = tb < n_tiles;
    while (tb > ta) {
      tb -= ta + 1;
      ++ta;
    }
    t.xo[m] = t.tile_live[m] ? ta : 0;
    t.yo[m] = t.tile_live[m] ? tb : 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) t.acc[m][q] = 0.f;
  }
  t.r[0] = t.r[1] = t.r[2] = 0.f;
  for_rated_rows<T>(a, t);
  float* dst = segment_gram(a, item);
  float* rdst = segment_rhs(a, item);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (!t.tile_live[m]) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * t.xo[m] + p, j = 4 * t.yo[m] + q;
        if (i < k && j <= i) dst[tight_row(i, j, k)] = t.acc[m][4 * p + q];
      }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (lane + 32 * q < k) rdst[lane + 32 * q] = t.r[q];
  finish(a, item);
}

template <typename Kernel>
int launch_gram(Kernel kernel, dim3 grid, size_t bytes, size_t max_bytes,
                cudaStream_t s, const GramArgs& a, int& configured) {
  // above 48 KB only after the attribute is raised (once per instance and
  // device, to the most any K of the instance needs)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (configured != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_bytes);
    if (err != cudaSuccess) return (int)err;
    configured = dev;
  }
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int KP>
int launch_rows(dim3 grid, cudaStream_t s, const GramArgs& a) {
  static int configured = -1;
  if (a.kv != KP) return (int)cudaErrorInvalidValue;
  return launch_gram(gram_rhs_rows<T, KP>, grid, GramSmem<T>::bytes(KP),
                     GramSmem<T>::bytes(KP), s, a, configured);
}

template <typename T>
int dispatch_inkernel(dim3 grid, cudaStream_t s, const GramArgs& a) {
  if (a.k <= 16) return launch_rows<T, 16>(grid, s, a);
  if (a.k <= 32) return launch_rows<T, 32>(grid, s, a);
  if (a.k <= 48) return launch_rows<T, 48>(grid, s, a);
  if (a.k <= 64) return launch_rows<T, 64>(grid, s, a);
  // 210 tiles of the padded triangle at K=79
  static int configured = -1;
  if (a.kv != (a.k + 3) / 4 * 4) return (int)cudaErrorInvalidValue;
  return launch_gram(gram_rhs_tiles<T, 7>, grid, GramSmem<T>::bytes(a.kv),
                     GramSmem<T>::bytes(kMaxK), s, a, configured);
}

// -- #4: hoisted operand ---------------------------------------------------

struct HoistArgs {
  const void* codes;
  int n_cols, rows, n_tiles, tiles_per_seg, items, k;
  const void* v;     // [n_frozen, k]
  const void* p;     // [n_frozen, 4 t4]: the packed rows, 16-byte aligned
  int t4;            // 4-entry pieces of a packed row (t_out / 4)
  float cs, cb;
  int part;          // floats of an item's partial: t_out + roundup(k, 4)
  float* partial;    // [S, items, part] when S > 1
  int* arrivals;     // [items / 8], zero between launches (S > 1)
  float* gram;       // [items, t_out]
  float* rhs;        // [items, k]
};

// Dynamic shared memory of #4: two code stages, the per-warp hit lists.
template <typename T>
struct HoistSmem {
  static constexpr int kStage = kItemsPerBlock * kTile;  // codes per stage
  static constexpr int kHitsOff = 2 * kStage * (int)sizeof(T);
  static constexpr size_t kBytes = kHitsOff + kItemsPerBlock * kTile * 2;
};

__device__ __forceinline__ void add4(float4& s, const float4 x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// A block owns 8 items, a warp each, over the frozen tiles of segment
// blockIdx.y: the code tiles are staged and compacted as #3 does them; each
// rated entry's packed row of p is read whole, lane l taking 4-entry pieces
// l, l + 32, ... (NV of them: t_out <= 128 NV) into its NV float4 sums,
// and its rhs term is K FMAs on v's row (lanes over k).  Then the sums go
// to the outputs (S = 1) or the segment's partial, whose last block sums
// the S partials in segment order.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, NV <= 17 ? 2 : 1)
gram_rhs_hoisted(const HoistArgs a) {
  using L = HoistSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* stage = reinterpret_cast<T*>(smem);
  uint16_t* hits = reinterpret_cast<uint16_t*>(smem + L::kHitsOff) + warp * kTile;
  const T* codes = static_cast<const T*>(a.codes);
  const float* v = static_cast<const float*>(a.v);
  const float* p = static_cast<const float*>(a.p);
  const int item0 = blockIdx.x * kItemsPerBlock;
  const int item = item0 + warp;
  const int k = a.k, t4 = a.t4;
  const int t0 = blockIdx.y * a.tiles_per_seg;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_seg);
  float4 acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float r[3] = {0.f, 0.f, 0.f};  // rhs entries lane, lane + 32, lane + 64

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

    // compact this item's rated entries of the tile, in order
    int count = 0;
    for (int q = 0; q < kTile; q += 32) {
      const T c = code_at(tile, a.rows, warp, q + lane);
      const unsigned m = __ballot_sync(kFull, c != 0);
      if (c != 0) hits[count + __popc(m & ((1u << lane) - 1u))] = (uint16_t)(q + lane);
      count += __popc(m);
    }
    __syncwarp();

#pragma unroll 1
    for (int e = 0; e < count; ++e) {
      const int q = hits[e];
      const int64_t n = n0 + q;
      const float* row = p + n * 4 * t4;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (lane + 32 * j < t4) add4(acc[j], ldg4(row + 4 * (lane + 32 * j)));
      const float w = fmaf(a.cs, (float)code_at(tile, a.rows, warp, q), a.cb);
      const float* vr = v + n * k;
#pragma unroll
      for (int q3 = 0; q3 < 3; ++q3)
        if (lane + 32 * q3 < k) r[q3] = fmaf(w, ldg1(vr + lane + 32 * q3), r[q3]);
    }
  }

  const bool split = gridDim.y > 1;
  float* g = split ? a.partial + ((size_t)blockIdx.y * a.items + item) * a.part
                   : a.gram + (size_t)item * 4 * t4;
  float* rd = split ? g + 4 * t4 : a.rhs + (size_t)item * k;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < t4) reinterpret_cast<float4*>(g)[lane + 32 * j] = acc[j];
#pragma unroll
  for (int q3 = 0; q3 < 3; ++q3)
    if (lane + 32 * q3 < k) rd[lane + 32 * q3] = r[q3];
  if (!split || !last_arrival(a.arrivals)) return;

  // the last block of the item block: the S partials in segment order, read
  // through L2 (other SMs wrote them)
  const int n_seg = gridDim.y;
  const size_t seg = (size_t)a.items * a.part;  // floats between segments
  const float* src = a.partial + (size_t)item * a.part;
  float4* out = reinterpret_cast<float4*>(a.gram + (size_t)item * 4 * t4);
  for (int c = lane; c < t4; c += 32) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_seg; ++s)
      add4(sum, __ldcg(reinterpret_cast<const float4*>(src + s * seg) + c));
    out[c] = sum;
  }
  for (int kk = lane; kk < k; kk += 32) {
    float sum = 0.f;
    for (int s = 0; s < n_seg; ++s) sum += __ldcg(src + s * seg + 4 * t4 + kk);
    a.rhs[(size_t)item * k + kk] = sum;
  }
}

template <typename T, int NV>
int launch_hoisted(dim3 grid, cudaStream_t s, const HoistArgs& a) {
  gram_rhs_hoisted<T, NV><<<grid, kThreads, HoistSmem<T>::kBytes, s>>>(a);
  return (int)cudaGetLastError();
}

// The instance of t_out: NV float4 sums a lane, t_out <= 128 NV
template <typename T>
int dispatch_hoisted(dim3 grid, cudaStream_t s, const HoistArgs& a) {
  if (a.t4 <= 32 * 2) return launch_hoisted<T, 2>(grid, s, a);     // tight K <= 22
  if (a.t4 <= 32 * 5) return launch_hoisted<T, 5>(grid, s, a);     // tight K <= 35
  if (a.t4 <= 32 * 10) return launch_hoisted<T, 10>(grid, s, a);   // tight K <= 50
  if (a.t4 <= 32 * 17) return launch_hoisted<T, 17>(grid, s, a);   // tight K <= 65
  return launch_hoisted<T, kHoistMaxVec>(grid, s, a);              // tight K <= 79
}

// The library's C entry point (dense8_gram_rhs.cu).  codes is [n_rows, n_cols],
// row-major, of code_bytes bytes each (1: int8, 2: int16), starting on a
// 16-byte boundary, both dimensions multiples of 512; rows != 0 makes the
// code rows the items.  The frozen axis's 512-entry tiles are split into
// `segments` runs of `tiles_per_seg` (every run non-empty); with more than
// one, `partial` is a float32 scratch [segments, items, part] and
// `arrivals` an int32 [items / 8] that is zero before the launch and left
// zero after it, so launches that share it must be ordered (one stream).
// v is [N, v_stride] row-major float (N = the frozen count).  p ==
// null selects the in-kernel products (#3): v_stride is the instance's
// width (16, 32, 48 or 64 up to k = 64, else roundup(k, 4); the wrapper's
// gram_row_floats) with zero columns past k, v starts on a 16-byte
// boundary, gram is [items, t_out] in the tight layout with rows past
// k(k+1)/2 zeroed, and part = k(k+1)/2 + k.  Otherwise (#4) v_stride is k,
// p is [N, t_out] row-major float on a 16-byte boundary with t_out a
// multiple of 4 up to 3328, every one of its rows is summed into gram
// [items, t_out], and part = t_out + roundup(k, 4).  gram and rhs [items,
// k] are float32.  Launches on `stream`, returns cudaGetLastError().
int gram_rhs_entry(const void* codes, int code_bytes, int n_rows, int n_cols,
                   int rows, int k, const void* v, int v_stride, const void* p,
                   int t_out, float cs, float cb, int segments,
                   int tiles_per_seg, void* partial, void* arrivals, void* gram,
                   void* rhs, void* stream) {
  const int items = rows ? n_rows : n_cols;
  const int n_frozen = rows ? n_cols : n_rows;
  if (k < 1 || k >= kMaxK || items < 1 || n_frozen < 1 ||
      (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_frozen / kTile;
  if (items % kItemsPerBlock != 0 || n_frozen % kTile != 0 ||
      n_cols % kItemsPerBlock != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (segments < 1 || segments > 65535 || tiles_per_seg < 1 ||
      (long long)segments * tiles_per_seg < n_tiles ||
      (long long)(segments - 1) * tiles_per_seg >= n_tiles ||
      (segments > 1 && (partial == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gf = static_cast<float*>(gram);
  float* rf = static_cast<float*>(rhs);
  const dim3 grid(items / kItemsPerBlock, segments);
  if (p != nullptr) {
    if (v_stride != k || t_out < 4 || t_out % 4 != 0 ||
        t_out > 4 * 32 * kHoistMaxVec || reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const HoistArgs a{codes, n_cols, rows, n_tiles, tiles_per_seg, items, k, v,
                      p, t_out / 4, cs, cb, t_out + (k + 3) / 4 * 4,
                      static_cast<float*>(partial), static_cast<int*>(arrivals),
                      gf, rf};
    return code_bytes == 1 ? dispatch_hoisted<int8_t>(grid, s, a)
                           : dispatch_hoisted<int16_t>(grid, s, a);
  }
  if (t_out < k * (k + 1) / 2 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const GramArgs a{codes, n_cols, rows, n_tiles, tiles_per_seg, items, k,
                   v, v_stride, cs, cb, t_out, static_cast<float*>(partial),
                   static_cast<int*>(arrivals), gf, rf};
  return code_bytes == 1 ? dispatch_inkernel<int8_t>(grid, s, a)
                         : dispatch_inkernel<int16_t>(grid, s, a);
}

}  // namespace

// The C entry point's parameters, for the file that defines it.
#define BPMF_GRAM_RHS_PARAMS                                                   \
  const void *codes, int code_bytes, int n_rows, int n_cols, int rows, int k, \
      const void *v, int v_stride, const void *p, int t_out, float cs,       \
      float cb, int segments, int tiles_per_seg, void *partial,              \
      void *arrivals, void *gram, void *rhs, void *stream
#define BPMF_GRAM_RHS_ARGS                                                     \
  codes, code_bytes, n_rows, n_cols, rows, k, v, v_stride, p, t_out, cs, cb, \
      segments, tiles_per_seg, partial, arrivals, gram, rhs, stream
