// The per-item Cholesky, substitutions and draw of one warp, shared by the
// packed-triangle solve (tri_combine_solve.cu, #5/#6/#7) and the solve of
// full precisions (chol_solve_sample.cu, #8).  The caller stages the
// item's system A (prior already combined) into the warp's area of shared
// memory w as the packed lower triangle in the tight layout (column j from
// w[tight_off(j, k)]) and calls one of:
//
// * solve_rows<KP>, K <= KP <= 64 (capacities 8, 16, 24, 32, 48, 64): row
//   i of A in the registers of lane i % 32, up to two rows a lane, entries
//   0 .. i only (96 registers at K=64, where two full 64-wide rows would
//   spill).  Right-looking Cholesky: each finished column of L goes to
//   shared memory (a compact column store over w, every column on a
//   16-byte boundary) and is read back by float4 broadcast.  The forward
//   pass uses shuffles, the back substitution runs by columns, and the
//   pivot's rsqrt serves as the inverse diagonal, so no step divides.  The
//   loops over the capacity are unrolled, so every predicate but the
//   lane's is fixed at compile time.  A K below the capacity is padded
//   block-diagonally in registers (identity rows, zero rhs and noise): the
//   padded rows draw exact zeros and are never written.  w needs
//   max(round4(K(K+1)/2), lcol_floats(KP)) floats.  Its factorization and
//   substitutions are solve_rows_regs<KP>, for a caller whose system is
//   already in registers (the dense8 megakernel at capacities 40 and 44).
// * solve_panels<R>, 32 < K <= 32R: the triangle stays in w with lanes over
//   rows (row i on lane i % 32), factored in place in panels of kPanel
//   columns: the panel's entries of the lane's rows in registers (pivots
//   and column entries by shuffle, rsqrt pivots), the panel's rows copied
//   into a row-major [K][kPanel] buffer p, and the trailing triangle
//   updated once per panel, kPanel FMAs per load and store, the panel row
//   read by two float4 broadcasts.  Both substitutions run by columns from
//   the factor in shared memory.  w needs round4(K(K+1)/2) floats, p 8K.
//
// Both compute u = L' \ (L \ rhs + noise), L L' = A, with no block-wide
// barrier: a warp may return as soon as its item is done.  A system that
// is not positive definite gives NaN (rsqrt of a non-positive pivot).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpmf {

constexpr unsigned kWarpFull = 0xffffffffu;
constexpr int kPanel = 8;  // columns per panel (solve_panels)

__host__ __device__ __forceinline__ int tight_off(int j, int k) {
  return j * k - j * (j - 1) / 2;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) / 4 * 4; }

// One item's right-hand side and noise (entry i at rhs[i * r_s] and
// noise[i * n_s]) and its draw's destination (entry i at out[i]).
struct ItemVecs {
  const float* rhs;
  int64_t r_s;
  const float* noise;
  int64_t n_s;
  float* out;
};

// Floats of the factor's column store at capacity KP: column j holds rows
// 4*(j/4) .. KP-1, so that every column starts on a 16-byte boundary and
// rows 4m .. 4m+3 of it are one float4.
__host__ __device__ constexpr int lcol_floats(int kp) {
  return kp * kp - 8 * (kp / 4) * (kp / 4 - 1);
}

// Start of column j in that store, less its first row 4*(j/4): entry
// (i, j), i >= 4*(j/4), lies at lcol_base(j) + i.
template <int KP>
__host__ __device__ __forceinline__ int lcol_base(int j) {
  const int q = j / 4;
  return 4 * KP * q - 8 * q * (q - 1) + (j % 4) * (KP - 4 * q) - 4 * q;
}

// The row groups of capacity KP: row i on lane i % 32, group i / 32.
template <int KP>
constexpr int kRowGroups = (KP + 31) / 32;

// The Cholesky and both substitutions of solve_rows on a system already in
// the lane's registers: g[r][j] = A_ij for row i = lane + 32r and j <= i
// (entries above the diagonal are never read into L), y[r] and noise[r]
// the rhs and noise of row i.  Rows k .. KP-1 must be padded (identity, zero
// rhs and noise); only rows below k are written to out[i].  w (the warp's
// area, lcol_floats(KP) floats) must be free: it becomes the factor's
// columns.  The dense8 megakernel (dense8_sweep_solve.cu) calls it on the
// Gram it summed in registers at capacities 40 and 44.
template <int KP>
__device__ __forceinline__ void solve_rows_regs(float (&g)[kRowGroups<KP>][KP],
                                                float (&y)[kRowGroups<KP>],
                                                const float (&noise)[kRowGroups<KP>],
                                                float* w, int k, float* out) {
  constexpr int R = kRowGroups<KP>;
  const int lane = threadIdx.x & 31;
  float inv[R], u[R];
  int colb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    inv[r] = u[r] = 0.f;
    colb[r] = lcol_base<KP>(lane + 32 * r);
  }

  // right-looking Cholesky: after step j, row i > j holds L_ij in g[.][j],
  // the owner of row j the inverse pivot, and column j of L lies in w,
  // whence every lane reads it by float4 broadcast for its update
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    const int jr = j / 32;
    const float d = rsqrtf(__shfl_sync(kWarpFull, g[jr][j], j % 32));
    float lij[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (32 * (r + 1) <= j) continue;  // rows of this group are above j
      const int i = lane + 32 * r;
      lij[r] = g[r][j] * d;
      g[r][j] = lij[r];
      if (i == j) inv[r] = d;
      if (i >= 4 * (j / 4) && i < KP) w[lcol_base<KP>(j) + i] = lij[r];
    }
    __syncwarp();
#pragma unroll
    for (int k4 = (j + 1) / 4; k4 < KP / 4; ++k4) {
      const float4 c = *reinterpret_cast<const float4*>(w + lcol_base<KP>(j) + 4 * k4);
      const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (32 * (r + 1) <= j) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 4 * k4 + q;
          if (col > j && col < 32 * (r + 1))
            g[r][col] = fmaf(-lij[r], cs[q], g[r][col]);
        }
      }
    }
  }

  // forward substitution L z = y (row i of L in its lane's registers)
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    const int jr = j / 32;
    if (lane == j % 32) y[jr] *= inv[jr];
    const float zj = __shfl_sync(kWarpFull, y[jr], j % 32);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * (r + 1) > j && lane + 32 * r > j) y[r] = fmaf(-g[r][j], zj, y[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] += noise[r];

  // back substitution L' u = y by columns: u_j = y_j / L_jj, then every
  // row i < j takes L_ji u_j off y_i, L_ji read from column i
#pragma unroll
  for (int j = KP - 1; j >= 0; --j) {
    const int jr = j / 32;
    if (lane == j % 32) u[jr] = y[jr] * inv[jr];
    const float uj = __shfl_sync(kWarpFull, u[jr], j % 32);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * r < j && lane + 32 * r < j) y[r] = fmaf(-w[colb[r] + j], uj, y[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < k) out[i] = u[r];
  }
}

// K <= KP <= 64: rows lane and lane + 32 of the system in registers (group
// r holds row lane + 32r, entries 0 .. min(KP, 32(r+1)) - 1), the
// megakernel's Cholesky and substitutions (solve_rows_regs).  w holds the
// item's packed system on entry and the factor's columns (lcol_base) after.
template <int KP>
__device__ __forceinline__ void solve_rows(float* w, int k, const ItemVecs& v) {
  constexpr int R = kRowGroups<KP>;
  const int lane = threadIdx.x & 31;
  float g[R][KP], y[R], noise[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = i < k ? __ldg(v.rhs + i * v.r_s) : 0.f;
    noise[r] = i < k ? __ldg(v.noise + i * v.n_s) : 0.f;
#pragma unroll
    for (int j = 0; j < KP && j < 32 * (r + 1); ++j)
      g[r][j] = (i < k && j <= i) ? w[tight_off(j, k) + i - j]
                                  : (i == j ? 1.f : 0.f);  // padded: identity
  }
  __syncwarp();  // w is the factor's columns from here
  solve_rows_regs<KP>(g, y, noise, w, k, v.out);
}

// Entry r of a lane's row registers, chosen by a warp-uniform row group.
template <int R>
__device__ __forceinline__ float pick(const float (&x)[R], int r) {
  float v = x[0];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if (r == q) v = x[q];
  return v;
}

// 32 < K <= 32R: the packed system in w (column j from w[tight_off(j)]),
// lanes over rows (row i on lane i % 32, group i / 32), factored in place
// in panels of kPanel columns; each diagonal entry ends as the inverse
// pivot.  p is the warp's [K][kPanel] row-major panel buffer.
template <int R>
__device__ __forceinline__ void solve_panels(float* w, float* p, int k,
                                             const ItemVecs& v) {
  const int lane = threadIdx.x & 31;
  float y[R], noise[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = i < k ? __ldg(v.rhs + i * v.r_s) : 0.f;
    noise[r] = i < k ? __ldg(v.noise + i * v.n_s) : 0.f;
  }

  for (int j0 = 0; j0 < k; j0 += kPanel) {
    // the panel's columns of this lane's rows (0 above the diagonal and
    // past K)
    float l[kPanel][R];
#pragma unroll
    for (int q = 0; q < kPanel; ++q) {
      const int j = j0 + q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        l[q][r] = (j < k && i >= j && i < k) ? w[tight_off(j, k) + i - j] : 0.f;
      }
    }
    // factor the panel in registers: pivots and column entries by shuffle
#pragma unroll
    for (int q = 0; q < kPanel; ++q) {
      const int j = j0 + q;
      if (j >= k) break;
      const float d = rsqrtf(__shfl_sync(kWarpFull, pick(l[q], j >> 5), j & 31));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        l[q][r] = i == j ? d : l[q][r] * d;
      }
#pragma unroll
      for (int c = q + 1; c < kPanel; ++c) {
        const int jc = j0 + c;
        if (jc >= k) break;
        const float lc = __shfl_sync(kWarpFull, pick(l[q], jc >> 5), jc & 31);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (lane + 32 * r >= jc) l[c][r] = fmaf(-l[q][r], lc, l[c][r]);
      }
    }
    // the panel back to w (columns of L), its rows below it to p
#pragma unroll
    for (int q = 0; q < kPanel; ++q) {
      const int j = j0 + q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        if (j < k && i >= j && i < k) w[tight_off(j, k) + i - j] = l[q][r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i >= j0 + kPanel && i < k) {
        float4* row = reinterpret_cast<float4*>(p + i * kPanel);
        row[0] = make_float4(l[0][r], l[1][r], l[2][r], l[3][r]);
        row[1] = make_float4(l[4][r], l[5][r], l[6][r], l[7][r]);
      }
    }
    __syncwarp();
    // trailing update: A_ic -= sum_q L_i,j0+q L_c,j0+q for c past the panel
    for (int c = j0 + kPanel; c < k; ++c) {
      const float4 c0 = reinterpret_cast<const float4*>(p + c * kPanel)[0];
      const float4 c1 = reinterpret_cast<const float4*>(p + c * kPanel)[1];
      float* col = w + tight_off(c, k) - c;  // col[i] = A_ic
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        if (32 * r + 31 < c) continue;  // the whole row group is above c
        if (i >= c && i < k) {
          float s = col[i];
          s = fmaf(-l[0][r], c0.x, s);
          s = fmaf(-l[1][r], c0.y, s);
          s = fmaf(-l[2][r], c0.z, s);
          s = fmaf(-l[3][r], c0.w, s);
          s = fmaf(-l[4][r], c1.x, s);
          s = fmaf(-l[5][r], c1.y, s);
          s = fmaf(-l[6][r], c1.z, s);
          s = fmaf(-l[7][r], c1.w, s);
          col[i] = s;
        }
      }
    }
    __syncwarp();
  }

  // forward substitution L z = y by columns
  for (int j = 0; j < k; ++j) {
    const float* col = w + tight_off(j, k) - j;
    const float zj = __shfl_sync(kWarpFull, pick(y, j >> 5), j & 31) * col[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == j) y[r] = zj;
      else if (i > j && i < k) y[r] = fmaf(-col[i], zj, y[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] += noise[r];
  // back substitution L' u = z + noise by columns: u_j = y_j / L_jj, then
  // every row i < j takes L_ji u_j off y_i, L_ji read from column i
  for (int j = k - 1; j >= 0; --j) {
    const float uj = __shfl_sync(kWarpFull, pick(y, j >> 5), j & 31) *
                     w[tight_off(j, k)];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == j) y[r] = uj;
      else if (i < j) y[r] = fmaf(-w[tight_off(i, k) + j - i], uj, y[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < k) v.out[i] = y[r];
  }
}

}  // namespace bpmf
