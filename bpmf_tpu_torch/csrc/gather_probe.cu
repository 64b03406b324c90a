// Gather-and-sum of neighbour rows for Hopper (sm_90a): three strategies
// for one function,
//
//   out[r, k] = sum_w table[idx[r, w], k],   idx [R, W] int32, table [NV, K] f32
//
// the neighbour gather of the bucketed route's Gram, reduced to its memory
// access.  They replace the three TPU micro-probes of scripts/gather_probe.py.
//
// What bounds them on an H100: bytes.  At the probe's shapes (R = W = 512,
// NV = 32768, K = 32) the function must read idx (1 MiB) and the table
// (4 MiB, nearly every row is touched) and write out (64 KiB): 5.3 MB,
// 0.0016 ms at 3.35 TB/s; the adds (8.4 M) are far below it.  But each
// launch gathers R*W rows (33.5 MB at those shapes), and the table stays in
// the 50 MB L2 across a launch, so what a design meets is L2's bandwidth
// and latency: enough 16-byte loads in flight on every SM.
//
//   gather_rows_kernel   <- :66 kernel_a (call :75): the whole table in VMEM,
//                           take_along_axis over sublanes.  Each item row's
//                           W neighbours are split over `split` warps (the
//                           plan, gather_probe.probe_plan_rows, picks it so
//                           that R*split warps fill the 132 SMs: 16 at
//                           R = 512, 1 at R = 8192).  A table row is SPAN
//                           lanes reading 16-byte pieces (K = 32: a quarter
//                           warp a 128-byte row, 4 rows a warp instruction,
//                           8 rows in flight a lane); the warp's indices
//                           come 32 at a time, one a lane, by shuffle.  The
//                           partials of a warp's sub-rows add by a
//                           butterfly, the split warps' through shared
//                           memory in warp order: no atomics, the same bits
//                           every launch.  K % 4 != 0 or a table off
//                           16-byte alignment takes the same kernel with
//                           4-byte pieces.
//   gather_lanes_kernel  <- :87 kernel_b (call :95): the transposed table
//                           [K, NV] in VMEM, gather along lanes.  A block
//                           stages one k-row table_t[k, :] (128 KB at
//                           NV = 32768) into shared memory with 16-byte
//                           cp.async (a 4-byte head and tail where the row
//                           is off 16-byte alignment), then its warps walk
//                           a group of item rows: lanes take neighbours w,
//                           read idx as int4 (4 neighbours a lane) and look
//                           each value up in shared memory; one warp-shuffle
//                           sum per (r, k).  The grid is K x row groups
//                           (the plan, probe_plan_lanes, sizes the groups
//                           to one wave).  What it reads from L2 is the
//                           staged rows and idx once per k: K*R*W*4 bytes,
//                           coalesced, no scattered global load.  Past
//                           about 58,000 floats a k-row does not fit the
//                           232,448 bytes a block may have: the block then
//                           stages the row chunk by chunk, each chunk adds
//                           only the indices that fall in it, and out[r, k]
//                           takes the chunks' sums in chunk order (the
//                           thread that wrote it adds the next one).
//   gather_copy_kernel   <- :107 kernel_c (call :128): one grid step per r,
//                           W row DMAs from HBM into a [W, K] VMEM scratch on
//                           one semaphore, then one sum.  Here persistent
//                           blocks (the plan, probe_plan_copy: two an SM)
//                           take item rows b, b + blocks, ... and stream
//                           their neighbours' rows through a ring of
//                           `stages` slots of `chunk` rows (3 of 256 rows, 32
//                           KB each, at K = 32).  Producer warp p copies rows
//                           [32 p, 32 p + 32) of each slot, a lane a row, with
//                           one bulk copy (cp.async.bulk, the TMA) that
//                           completes its bytes on the slot's "full"
//                           mbarrier, after waiting on the slot's "empty"
//                           one; its lanes load their rows' indices 4 chunks
//                           ahead.  Four consumer warps wait on "full", sum
//                           their share of the slot's rows in registers (a
//                           lane a column), release the slot, and at the end
//                           of an item row add their partials in warp order:
//                           no atomics, the same bits every launch.  The
//                           ring's size depends on K, not on W.  K % 4 != 0
//                           or a table off 16-byte alignment fills the same
//                           ring with 4-byte cp.async, which arrive on
//                           "full" through cp.async.mbarrier.arrive.noinc;
//                           past 1024 columns a row goes in slabs of 1024.
//                           What bounds it on an H100: TMA requests, not
//                           bytes (about 340 row copies a microsecond an SM
//                           at R = 8192, PERF.md), so it stays behind A.
//
// The indices must lie in [0, NV): the kernels do not check them, as the
// TPU kernels do not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsWarps = 16;  // A: warps a block
constexpr int kRowsThreads = kWarp * kRowsWarps;
constexpr int kLanesThreads = 1024;  // B
constexpr int kCopyConsumers = 4;  // C: consumer warps a block
constexpr int kCopyMaxProducers = 8;  // C: producer warps, one a 32 rows of a slot
constexpr int kCopyMaxChunk = kWarp * kCopyMaxProducers;  // table rows a slot
constexpr int kCopyMaxThreads = kWarp * (kCopyMaxProducers + kCopyConsumers);
constexpr int kCopyMaxStages = 16;
constexpr int kCopyAhead = 4;  // C: chunks whose indices a producer holds
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ float shfl_xor(float x, int off) {
  return __shfl_xor_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ float4 shfl_xor(float4 x, int off) {
  return make_float4(shfl_xor(x.x, off), shfl_xor(x.y, off),
                     shfl_xor(x.z, off), shfl_xor(x.w, off));
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// A: V is the piece a lane reads (float4, or float for K % 4 != 0 or a
// table off 16-byte alignment), SPAN the lanes of one table row (the
// pieces of a row rounded up to a power of two, at most 32), so a warp
// instruction reads kWarp / SPAN rows.  Warp q of the block serves item row
// blockIdx.x * (kRowsWarps / split) + q / split and its neighbours
// [s * per_warp, (s + 1) * per_warp), s = q % split.
template <typename V, int SPAN>
__global__ void __launch_bounds__(kRowsThreads, 2)
gather_rows_kernel(const int32_t* __restrict__ idx,    // [R, W]
                   const float* __restrict__ table,    // [NV, K]
                   int r_rows, int w_cols, int k, int split, int per_warp,
                   float* __restrict__ out)            // [R, K]
{
  extern __shared__ __align__(16) float part[];  // [kRowsWarps, K], split > 1
  constexpr int kE = sizeof(V) / sizeof(float);
  constexpr int kStride = kWarp / SPAN;  // table rows a warp instruction
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int rows = kRowsWarps / split;
  const int64_t r = int64_t(blockIdx.x) * rows + warp / split;
  const bool live = r < r_rows;
  const int sub = lane / SPAN;
  const int pieces = k / kE;
  const int w_lo = min(w_cols, (warp % split) * per_warp);
  const int w_hi = min(w_cols, w_lo + per_warp);
  const V* table_v = reinterpret_cast<const V*>(table);
  const int32_t* row_idx = idx + (live ? r : 0) * w_cols;
  V* dst = split > 1 ? reinterpret_cast<V*>(part + warp * k)
                     : reinterpret_cast<V*>(out + (live ? r : 0) * k);
  for (int p0 = 0; p0 < pieces; p0 += SPAN) {
    const int p = p0 + lane % SPAN;
    V acc = zero<V>();
    if (live) {
      for (int wb = w_lo; wb < w_hi; wb += kWarp) {
        const int n = min(kWarp, w_hi - wb);
        const int32_t mine = lane < n ? __ldg(row_idx + wb + lane) : 0;
        // SPAN instructions of kStride rows each: up to 8 pieces in flight
#pragma unroll 8
        for (int t = 0; t < SPAN; ++t) {
          const int j = sub + t * kStride;
          const int64_t v = __shfl_sync(0xffffffffu, mine, j);
          if (j < n && p < pieces) add(acc, __ldg(table_v + v * pieces + p));
        }
      }
    }
#pragma unroll
    for (int off = SPAN; off < kWarp; off *= 2) add(acc, shfl_xor(acc, off));
    if (live && sub == 0 && p < pieces) dst[p] = acc;
  }
  if (split > 1) {
    __syncthreads();
    for (int t = threadIdx.x; t < rows * k; t += kRowsThreads) {
      const int i = t / k, kk = t - i * k;
      const int64_t rr = int64_t(blockIdx.x) * rows + i;
      if (rr >= r_rows) break;
      float s = 0.0f;
      for (int q = 0; q < split; ++q) s += part[(i * split + q) * k + kk];
      out[rr * k + kk] = s;
    }
  }
}

__device__ __forceinline__ float look(const float* vals, int32_t d, int n) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(n) ? vals[d] : 0.0f;
}

// B: block (k, g) holds chunk [c0, c0 + n) of table_t[k, :] in shared
// memory, chunk after chunk, and sums out[r, k] for the rows
// [g * rows_per_block, (g + 1) * rows_per_block), a warp a row at a time.
__global__ void __launch_bounds__(kLanesThreads)
gather_lanes_kernel(const int32_t* __restrict__ idx,    // [R, W]
                    const float* __restrict__ table_t,  // [K, NV]
                    int r_rows, int w_cols, int nv, int k, int rows_per_block,
                    int chunk, float* __restrict__ out)  // [R, K]
{
  extern __shared__ __align__(16) float stage[];  // chunk + 3 floats
  constexpr int kWarps = kLanesThreads / kWarp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int kk = blockIdx.x;
  const int64_t r0 = int64_t(blockIdx.y) * rows_per_block;
  const int64_t r1 = min(int64_t(r_rows), r0 + rows_per_block);
  const bool quads =
      w_cols % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  for (int c0 = 0; c0 < nv; c0 += chunk) {
    const int n = min(chunk, nv - c0);
    const float* src = table_t + int64_t(kk) * nv + c0;
    // vals[j] = src[j], placed so that the 16-byte copies land aligned
    const int a = int((reinterpret_cast<uintptr_t>(src) / 4) % 4);
    const int head = min(n, (4 - a) % 4);
    const int quads_n = (n - head) / 4;
    float* vals = stage + a;
    __syncthreads();  // the last chunk's lookups are done
    for (int t = threadIdx.x; t < head; t += kLanesThreads) vals[t] = src[t];
    for (int q = threadIdx.x; q < quads_n; q += kLanesThreads)
      cp_async16(vals + head + 4 * q, src + head + 4 * q);
    for (int t = head + 4 * quads_n + threadIdx.x; t < n; t += kLanesThreads)
      vals[t] = src[t];
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (int64_t r = r0 + warp; r < r1; r += kWarps) {
      const int32_t* row = idx + r * w_cols;
      float acc = 0.0f;
      if (quads) {
        const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
        for (int q = lane; q < w_cols / 4; q += kWarp) {
          const int4 v = __ldg(row4 + q);
          acc += look(vals, v.x - c0, n);
          acc += look(vals, v.y - c0, n);
          acc += look(vals, v.z - c0, n);
          acc += look(vals, v.w - c0, n);
        }
      } else {
#pragma unroll 8
        for (int w = lane; w < w_cols; w += kWarp)
          acc += look(vals, __ldg(row + w) - c0, n);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        float* o = out + r * k + kk;
        *o = c0 == 0 ? acc : *o + acc;
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

// mbarriers: a phase completes when `count` arrivals (and, after an
// expect_tx, that many bytes of bulk copies) have come in
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// the calling thread's earlier cp.asyncs arrive on `bar` once they have
// landed (one of the arrivals its init count expects)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}
// one bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) that completes its bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of gather_copy_kernel in bytes: the ring [stages][chunk]
// [cols], two sets of the consumers' [cols] partials, then the stages'
// "full" and "empty" mbarriers.
__host__ __device__ __forceinline__ long long copy_bar_offset(int stages, int chunk,
                                                              int cols) {
  const long long floats = (long long)stages * chunk * cols + 2LL * kCopyConsumers * cols;
  return 4 * (floats + floats % 2);
}
__host__ __device__ __forceinline__ long long copy_smem(int stages, int chunk, int cols) {
  return copy_bar_offset(stages, chunk, cols) + 16LL * stages;
}

// Where a block is in its walk over (item row, slab, chunk), block b taking
// item rows b, b + gridDim.x, ...
struct CopyTask {
  int64_t r;
  int s, c;
  __device__ __forceinline__ void next(int slabs, int chunks) {
    if (++c < chunks) return;
    c = 0;
    if (++s < slabs) return;
    s = 0;
    r += gridDim.x;
  }
};

// C: BULK, the producers copy a row with one bulk copy (the TMA; `width`
// floats), else with 4-byte cp.async pieces.  Each item row goes in slabs
// of `cols` columns, each slab's W neighbours in chunks of `chunk` rows,
// one chunk a ring slot.  Warp p < ceil(chunk / 32) copies the chunk's
// rows [32 p, 32 p + 32), its lane l's index loaded kCopyAhead chunks
// ahead; the kCopyConsumers warps after them sum, warp q the rows q,
// q + kCopyConsumers, ...
template <bool BULK>
__global__ void __launch_bounds__(kCopyMaxThreads)
gather_copy_kernel(const int32_t* __restrict__ idx,    // [R, W]
                   const float* __restrict__ table,    // [NV, K]
                   int r_rows, int w_cols, int k, int cols, int chunk, int stages,
                   float* __restrict__ out)            // [R, K]
{
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* part = ring + stages * chunk * cols;  // [2][kCopyConsumers][cols]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + copy_bar_offset(stages, chunk, cols));
  uint64_t* empty = full + stages;
  const int producers = (chunk + kWarp - 1) / kWarp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // bulk: each producer warp's expect_tx; cp.async: each producer lane's
      mbar_init(full + s, BULK ? producers : kWarp * producers);
      mbar_init(empty + s, kCopyConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slabs = (k + cols - 1) / cols;
  const int chunks = (w_cols + chunk - 1) / chunk;
  int stage = 0;
  unsigned phase = 0;
  if (warp < producers) {
    const int lo = warp * kWarp;  // this warp's rows of a chunk
    // the indices of the next kCopyAhead chunks, row lo + lane of each
    CopyTask ahead{blockIdx.x, 0, 0};
    auto load_ahead = [&]() {
      const int i = ahead.c * chunk + lo + lane;
      const int32_t x = ahead.r < r_rows && lo + lane < chunk && i < w_cols
                            ? __ldg(idx + ahead.r * w_cols + i) : 0;
      ahead.next(slabs, chunks);
      return x;
    };
    int32_t v[kCopyAhead];
#pragma unroll
    for (int a = 0; a < kCopyAhead; ++a) v[a] = load_ahead();
    for (CopyTask t{blockIdx.x, 0, 0}; t.r < r_rows; t.next(slabs, chunks)) {
      const int c0 = t.s * cols, width = min(cols, k - c0);
      const int m = min(kWarp, min(chunk, w_cols - t.c * chunk) - lo);
      const int32_t mine = v[0];
#pragma unroll
      for (int a = 0; a + 1 < kCopyAhead; ++a) v[a] = v[a + 1];
      v[kCopyAhead - 1] = load_ahead();
      mbar_wait(empty + stage, phase ^ 1);
      float* dst = ring + (stage * chunk + lo) * cols;
      const float* src = table + c0;
      if constexpr (BULK) {
        if (lane == 0) mbar_arrive_expect_tx(full + stage, 4u * max(m, 0) * width);
        __syncwarp();
        if (lane < m)
          bulk_copy(dst + lane * cols, src + int64_t(mine) * k, 4u * width,
                    full + stage);
      } else {
        // SPAN lanes a row, neighbouring lanes on neighbouring floats
        int span = 1;
        while (span < width && span < kWarp) span *= 2;
        const int per = kWarp / span, sub = lane / span;
        for (int j0 = 0; j0 < kWarp; j0 += per) {
          const int j = j0 + sub;
          const int64_t row = __shfl_sync(0xffffffffu, mine, j);
          if (j >= m) continue;
          for (int p = lane % span; p < width; p += span)
            cp_async4(dst + j * cols + p, src + row * k + p);
        }
        cp_async_arrive(full + stage);
      }
      if (++stage == stages) { stage = 0; phase ^= 1; }
    }
    if constexpr (!BULK) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  const int q = warp - producers, t = threadIdx.x - producers * kWarp;
  int buf = 0;
  for (int64_t r = blockIdx.x; r < r_rows; r += gridDim.x) {
    for (int s = 0; s < slabs; ++s) {
      const int c0 = s * cols, width = min(cols, k - c0);
      float* mine = part + (buf * kCopyConsumers + q) * cols;
      for (int c = 0; c < chunks; ++c) {
        const int n = min(chunk, w_cols - c * chunk);
        mbar_wait(full + stage, phase);
        const float* rows = ring + stage * chunk * cols;
        for (int col = lane; col < width; col += kWarp) {
          float acc = 0.0f;
#pragma unroll 8
          for (int i = q; i < n; i += kCopyConsumers) acc += rows[i * cols + col];
          mine[col] = c == 0 ? acc : mine[col] + acc;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }
      // the consumers' partials, in warp order; the next slab writes the
      // other set, so one barrier a slab keeps this one until it is read
      asm volatile("bar.sync 1, %0;\n" ::"r"(kCopyConsumers * kWarp) : "memory");
      const float* sets = part + buf * kCopyConsumers * cols;
      for (int col = t; col < width; col += kCopyConsumers * kWarp) {
        float acc = 0.0f;
        for (int p = 0; p < kCopyConsumers; ++p) acc += sets[p * cols + col];
        out[r * k + c0 + col] = acc;
      }
      buf ^= 1;
    }
  }
}

// Raises the kernel's dynamic shared memory to `smem` (above 48 KB only
// after the attribute is raised; otherwise the launch is refused and only
// its return code says so).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename V, int SPAN>
int launch_rows(const int32_t* idx, const float* table, int r_rows, int w_cols,
                int k, int split, int per_warp, float* out,
                cudaStream_t stream) {
  // the split warps' [kRowsWarps, K] partials
  const long long smem = split > 1 ? (long long)sizeof(float) * kRowsWarps * k : 0;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gather_rows_kernel<V, SPAN>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kRowsWarps / split;
  gather_rows_kernel<V, SPAN><<<(r_rows + rows - 1) / rows, kRowsThreads,
                                (size_t)smem, stream>>>(
      idx, table, r_rows, w_cols, k, split, per_warp, out);
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch_rows(const int32_t* idx, const float* table, int r_rows,
                  int w_cols, int k, int split, int per_warp, float* out,
                  cudaStream_t stream) {
  const int pieces = k / (int)(sizeof(V) / sizeof(float));
  int span = 1;
  while (span < pieces && span < kWarp) span *= 2;
  switch (span) {
    case 1: return launch_rows<V, 1>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
    case 2: return launch_rows<V, 2>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
    case 4: return launch_rows<V, 4>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
    case 8: return launch_rows<V, 8>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
    case 16: return launch_rows<V, 16>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
    default: return launch_rows<V, 32>(idx, table, r_rows, w_cols, k, split, per_warp, out, stream);
  }
}

template <bool BULK>
int launch_copy(const int32_t* idx, const float* table, int r_rows, int w_cols,
                int k, int blocks, int chunk, int stages, int cols, float* out,
                cudaStream_t stream) {
  const long long smem = copy_smem(stages, chunk, cols);
  cudaError_t err = allow_smem(gather_copy_kernel<BULK>, smem);
  if (err != cudaSuccess) return (int)err;
  const int producers = (chunk + kWarp - 1) / kWarp;
  gather_copy_kernel<BULK><<<blocks, kWarp * (producers + kCopyConsumers),
                             (size_t)smem, stream>>>(
      idx, table, r_rows, w_cols, k, cols, chunk, stages, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  idx is [R, W] int32, the
// tables and out row-major float32.  Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
// The plans (split, per_warp; rows_per_block, chunk; blocks, chunk, stages,
// cols) come from bpmf_tpu_torch/scripts/gather_probe.py; each kernel
// sizes its shared memory from them.
extern "C" int bpmf_gather_rows(const void* idx, const void* table, int r_rows,
                                int w_cols, int k, int split, int per_warp,
                                void* out, void* stream) {
  if (r_rows < 1 || w_cols < 1 || k < 1 || split < 1 ||
      split > kRowsWarps || kRowsWarps % split ||
      (long long)split * per_warp < w_cols)
    return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0)
    return dispatch_rows<float4>(ix, t, r_rows, w_cols, k, split, per_warp, o, s);
  return dispatch_rows<float>(ix, t, r_rows, w_cols, k, split, per_warp, o, s);
}

extern "C" int bpmf_gather_lanes(const void* idx, const void* table_t,
                                 int r_rows, int w_cols, int nv, int k,
                                 int rows_per_block, int chunk, void* out,
                                 void* stream) {
  // a chunk and the 3 floats that align its 16-byte copies, in 16-byte units
  const long long smem = 16 * (((long long)sizeof(float) * (chunk + 3) + 15) / 16);
  if (r_rows < 1 || w_cols < 1 || nv < 1 || k < 1 || rows_per_block < 1 ||
      chunk < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const long long groups = (r_rows + (long long)rows_per_block - 1) / rows_per_block;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gather_lanes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gather_lanes_kernel<<<dim3(k, (unsigned)groups), kLanesThreads, (size_t)smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(table_t),
      r_rows, w_cols, nv, k, rows_per_block, chunk, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int bpmf_gather_copy(const void* idx, const void* table, int r_rows,
                                int w_cols, int k, int blocks, int chunk,
                                int stages, int cols, void* out, void* stream) {
  if (r_rows < 1 || w_cols < 1 || k < 1 || blocks < 1 || chunk < 1 ||
      chunk > kCopyMaxChunk || stages < 1 || stages > kCopyMaxStages ||
      cols < 1 || cols > k || copy_smem(stages, chunk, cols) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // bulk copies need K, the slab width and the table 16-byte aligned
  if (k % 4 == 0 && cols % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0)
    return launch_copy<true>(ix, t, r_rows, w_cols, k, blocks, chunk, stages, cols, o, s);
  return launch_copy<false>(ix, t, r_rows, w_cols, k, blocks, chunk, stages, cols, o, s);
}
