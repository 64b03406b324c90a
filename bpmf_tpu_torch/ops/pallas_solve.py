"""Packed-triangle layouts, the fused combine-solve-sample of the dense8
split pipeline and the fused dense route, and the batched solve of full
precisions (port of ``bpmf_tpu/ops/pallas_solve.py``).

Host part: numpy copies of the JAX package's layout helpers and its VMEM
gate (``tri_offsets``, ``tri_index_pairs``, ``tri_tight_pairs``,
``tri_fused_supported``, ``pack_prior_tri``).  They are copied, not
imported, because that module imports jax; ``tests/test_torch_layout.py``
pins each copy to its original.  The helpers that depend on the
per-item prior's layout take ``grouped``: False for the bottom-padded
layout (the JAX package's default), True for the top-aligned one that
``BPMF_TRI_GROUPED=1`` selects there (``tri_grouped``, K % 8 == 0).  The
JAX package pins that flag at first consult; the port reads it once, in
``BPMF._route``, and passes it down, so packing and solving never disagree.

Device part: :func:`tri_combine_solve_sample`, the per-item conditional
tail (prior combine, Cholesky, both substitutions, the draw) as one
hand-written CUDA kernel (``csrc/tri_combine_solve.cu``), and
:func:`tri_combine_solve_sample_ref`, its plain PyTorch version.  The
wrapper runs the plain version only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.  The kernel gives each item a warp (8
items a block) and reads the Gram in the tight layout the Gram kernel
writes, item-major or batch-last, so the JAX pipeline's ``tri_expand_rows``
(tight to aligned, a copy of every Gram) has no counterpart here.  The JAX package's
grouped kernels (Queue 2 #7: ``_kernel_tri_fused_grouped``,
``_kernel_tri_fused_peritem_grouped``) do #5/#6's arithmetic on the live
elements of the top-aligned layout; here they are the same kernel with
the per-item prior read at that layout's row offsets.
:func:`prior_rhs_from_tri` is a torch op, as it is an XLA op in the JAX
package.

:func:`chol_solve_sample_pallas_blast` is the solve of the bucketed and
plain dense routes (solver ``pallas``/``smart``): a hand-written CUDA kernel
(``csrc/chol_solve_sample.cu``, Queue 2 #8) that reads the item-major
[B, K, K] precision directly, where the TPU kernel transposes the batch
last and pads it with identity systems.  It gives each item a warp and
runs #5's solve (``csrc/warp_chol.cuh``) at the instance
:func:`blast_instance` names; its plain version is
:func:`chol_solve_sample_pallas_blast_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from bpmf_tpu_torch.ops.cholsolve import chol_solve_sample_vpu, smart_uses_kernel
from bpmf_tpu_torch.ops.mvnormal import cholesky_or_nan

__all__ = [
    "tri_offsets",
    "tri_index_pairs",
    "tri_tight_pairs",
    "tri_fused_supported",
    "tight_rows",
    "tri_combine",
    "tri_combine_solve_sample",
    "tri_combine_solve_sample_ref",
    "pack_prior_tri",
    "prior_rhs_from_tri",
    "chol_solve_sample_pallas_blast",
    "chol_solve_sample_pallas_blast_ref",
    "blast_instance",
]

# CUDA launches of the packed-triangle solve with the shared prior (#5)
# and the per-item prior (#6), in the bottom-padded layout or the grouped
# one (#7), and of the batched solve (#8), counted where they launch
solve_launches = {"shared": 0, "peritem": 0, "shared_grouped": 0,
                  "peritem_grouped": 0, "blast": 0}


def tri_offsets(k: int, align: int = 8):
    """(offs, T): column j of the lower triangle occupies rows
    [offs[j], offs[j] + k - j) of the 8-aligned packed layout, padded below
    to a multiple of ``align``.  Copy of ``pallas_solve.tri_offsets``."""
    offs = []
    t = 0
    for j in range(k):
        offs.append(t)
        t += ((k - j + align - 1) // align) * align
    return offs, t


def _top(offs, j: int, grouped: bool) -> int:
    """First row of column j's segment: offs[j], or offs[j] + j % 8 in the
    top-aligned layout, whose slot block covers full-matrix rows
    [8*(j//8), k)."""
    return offs[j] + (j % 8 if grouped else 0)


def tri_index_pairs(k: int, align: int = 8, grouped: bool = False):
    """(ii, jj) of length T for the aligned layout, bottom-padded or, with
    ``grouped``, top-aligned (entry (i, j) at row offs[j] + j % 8 + i - j);
    padding rows repeat (0, 0).  Copy of ``pallas_solve.tri_index_pairs``,
    its ``tri_grouped(k)`` passed in as ``grouped``."""
    offs, t_total = tri_offsets(k, align)
    ii = np.zeros((t_total,), np.int32)
    jj = np.zeros((t_total,), np.int32)
    for j in range(k):
        top = _top(offs, j, grouped)
        ii[top: top + k - j] = np.arange(j, k)
        jj[top: top + k - j] = j
    return ii, jj


def tri_tight_pairs(k: int, align: int = 16):
    """(ii, jj, row_map) of the tightly packed lower triangle, padded to a
    multiple of ``align`` rows with (0, 0); ``row_map`` maps aligned rows to
    tight rows.  Copy of ``pallas_solve.tri_tight_pairs``."""
    tri = [(i, j) for j in range(k) for i in range(j, k)]
    t_tight = ((len(tri) + align - 1) // align) * align
    ii = np.zeros((t_tight,), np.int32)
    jj = np.zeros((t_tight,), np.int32)
    for t, (i, j) in enumerate(tri):
        ii[t], jj[t] = i, j
    tight_off = np.concatenate(
        [[0], np.cumsum([k - j for j in range(k)])]).astype(np.int32)
    ai, aj = tri_index_pairs(k)
    row_map = tight_off[aj] + (ai - aj)
    return ii, jj, row_map.astype(np.int32)


def tri_fused_supported(k: int, peritem: bool = False) -> bool:
    """The JAX package's VMEM gate for the fused tri kernel: it decides
    which K ride dense8 at all (79 with the shared prior, 74 with a
    per-item prior), so the port takes the same routes.  Copy of
    ``pallas_solve.tri_fused_supported``."""
    _, t_total = tri_offsets(k)
    t_eff = t_total * (2 if peritem else 1)
    return (t_eff + 3 * k * k) * 128 * 4 <= 11 * 1024 * 1024


def tight_rows(k: int) -> int:
    """Rows of the tight packed triangle, K(K+1)/2 rounded up to 16 (the
    length of :func:`tri_tight_pairs`)."""
    return (k * (k + 1) // 2 + 15) // 16 * 16


@functools.cache
def _tight_entries(k: int, grouped: bool = False):
    """(ii, jj, aligned row) of each valid row of the tight layout; the
    aligned row in the layout ``grouped`` names."""
    ii, jj, _ = tri_tight_pairs(k)
    tv = k * (k + 1) // 2
    offs, _ = tri_offsets(k)
    ii, jj = ii[:tv], jj[:tv]
    return ii, jj, np.asarray([_top(offs, j, grouped) for j in jj]) + ii - jj


def pack_prior_tri(prop_lambda, k: int, grouped: bool = False) -> np.ndarray:
    """[num, K, K] symmetric per-item prior precision -> [T, num] aligned
    packed lower triangle (top-aligned with ``grouped``), batch-last
    (host-side, once at setup).  Copy of ``pallas_solve.pack_prior_tri``."""
    ii, jj = tri_index_pairs(k, grouped=grouped)
    return np.ascontiguousarray(np.asarray(prop_lambda)[:, ii, jj].T)


@functools.cache
def _prior_rhs_consts(k: int, grouped: bool = False):
    """Copy of ``pallas_solve._prior_rhs_consts``: (ii, jj) and the
    row-routing one-hots A, B [K, T], padding rows zero."""
    ii, jj = tri_index_pairs(k, grouped=grouped)
    offs, t_total = tri_offsets(k)
    valid = np.zeros(t_total, bool)
    for j in range(k):
        top = _top(offs, j, grouped)
        valid[top: top + k - j] = True
    a = np.zeros((k, t_total), np.float32)
    a[ii, np.arange(t_total)] = valid
    bmat = np.zeros((k, t_total), np.float32)
    bmat[jj, np.arange(t_total)] = valid & (ii != jj)
    return ii, jj, a, bmat


def prior_rhs_from_tri(prior_tri_t: torch.Tensor, mu: torch.Tensor,
                       grouped: bool = False) -> torch.Tensor:
    """Per-item prior rhs Lambda_i @ mu, [K, B], from the packed triangle in
    the layout ``grouped`` names: one [K, T] @ [T, B] matmul against a
    mu-weighted routing matrix (``pallas_solve.prior_rhs_from_tri``, the
    strict_reference quirk)."""
    ii, jj, a, bmat = _prior_rhs_consts(mu.shape[0], grouped)
    dev, dt = prior_tri_t.device, prior_tri_t.dtype
    m1 = (torch.as_tensor(a, dtype=dt, device=dev)
          * mu[torch.as_tensor(jj, dtype=torch.long, device=dev)][None, :]
          + torch.as_tensor(bmat, dtype=dt, device=dev)
          * mu[torch.as_tensor(ii, dtype=torch.long, device=dev)][None, :])
    return m1 @ prior_tri_t


def _check_solve_args(gram_t, lam, rhs_t, noise_t, lam_tri_t):
    k, b = rhs_t.shape
    _, t_total = tri_offsets(k)
    want = {"gram_t": (tight_rows(k), b), "lam": (k, k), "noise_t": (k, b),
            "lam_tri_t": (t_total, b)}
    for name, t in (("gram_t", gram_t), ("lam", lam),
                    ("noise_t", noise_t), ("lam_tri_t", lam_tri_t)):
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
        if t.device != rhs_t.device:
            raise ValueError(f"{name} is on {t.device}, rhs_t on {rhs_t.device}")
        if t.dtype != rhs_t.dtype:
            raise ValueError(f"{name} is {t.dtype}, rhs_t is {rhs_t.dtype}")
    return k, b


def tri_combine_solve_sample(
    gram_t: torch.Tensor,       # [T_tight, B] tight packed Gram, batch-last
    lam: torch.Tensor,          # [K, K] shared prior precision
    rhs_t: torch.Tensor,        # [K, B] data rhs + prior rhs
    noise_t: torch.Tensor,      # [K, B] N(0, I) draws
    alpha: float,
    lam_tri_t: Optional[torch.Tensor] = None,  # [T, B] per-item prior
    grouped: bool = False,      # lam_tri_t in the top-aligned layout
) -> torch.Tensor:
    """u_t [K, B] with (Lambda_b + alpha * Gram_b) u_b = rhs_b + L_b noise_b,
    L_b L_b' = Lambda_b + alpha * Gram_b; Lambda_b is ``lam`` or, when
    ``lam_tri_t`` is given, item b's packed prior in the aligned layout of
    :func:`pack_prior_tri` (top-aligned when ``grouped``).  Signature of
    ``bpmf_tpu.ops.pallas_solve.tri_combine_solve_sample``, except that the
    Gram comes in the tight layout of the Gram kernels
    (``dense8_gram_rhs_rows/cols``), where the JAX function takes it after
    ``tri_expand_rows``, and that ``grouped`` is passed in where the JAX
    function consults its pinned ``tri_grouped(k)``.  Only the valid rows
    of both layouts are read: ``pack_prior_tri``'s padding rows are not
    zero.

    CPU tensors take :func:`tri_combine_solve_sample_ref`; CUDA tensors the
    kernel (float32, K within :func:`tri_fused_supported`; ``grouped`` only
    for K % 8 == 0, the JAX package's rule).  Any strides are accepted; the
    result is the transposed view of a row-major [B, K] tensor."""
    k, b = _check_solve_args(gram_t, lam, rhs_t, noise_t, lam_tri_t)
    if grouped and k % 8:
        raise ValueError(f"the grouped layout needs K % 8 == 0, got K={k}")
    if rhs_t.device.type == "cpu":
        return tri_combine_solve_sample_ref(gram_t, lam, rhs_t, noise_t,
                                            alpha, lam_tri_t, grouped)
    if rhs_t.device.type != "cuda":
        raise ValueError(f"tri_combine_solve_sample: no kernel for {rhs_t.device}")
    if rhs_t.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel is float32-only, got {rhs_t.dtype}")
    if not tri_fused_supported(k, lam_tri_t is not None):
        raise ValueError(f"K={k} is beyond the dense8 gate (tri_fused_supported)")
    lam_c = lam.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=rhs_t.device)
    lt = (None, 0, 0) if lam_tri_t is None else (lam_tri_t.data_ptr(),
                                                 *lam_tri_t.stride())
    err = _kernel()(
        gram_t.data_ptr(), *gram_t.stride(), lam_c.data_ptr(), *lt,
        int(grouped), rhs_t.data_ptr(), *rhs_t.stride(),
        noise_t.data_ptr(), *noise_t.stride(),
        k, b, alpha, out.data_ptr(),
        torch.cuda.current_stream(rhs_t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"tri_combine_solve_sample kernel launch failed: cudaError {err}")
    key = "peritem" if lam_tri_t is not None else "shared"
    solve_launches[key + "_grouped" if grouped else key] += 1
    return out.t()


@functools.cache
def _kernel():
    """The built kernel's C entry point (built on first use)."""
    from bpmf_tpu_torch.ops._build import load

    fn = load("tri_combine_solve").bpmf_tri_combine_solve
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.restype = ctypes.c_int
    fn.argtypes = [p, i64, i64, p, p, i64, i64, i, p, i64, i64, p, i64, i64,
                   i, i, ctypes.c_float, p, p]
    return fn


def tri_combine(gram_t, lam, alpha, lam_tri_t=None, grouped=False):
    """The systems A_b = Lambda_b + alpha * Gram_b of
    :func:`tri_combine_solve_sample` as [B, K, K] lower triangles (zeros
    above the diagonal), gathered from the valid rows of both layouts
    (the prior's top-aligned when ``grouped``)."""
    k, b = lam.shape[0], gram_t.shape[1]
    ii, jj, arow = _tight_entries(k, grouped)
    dev = gram_t.device
    i_t = torch.as_tensor(ii, dtype=torch.long, device=dev)
    j_t = torch.as_tensor(jj, dtype=torch.long, device=dev)
    base = (lam[i_t, j_t][:, None] if lam_tri_t is None
            else lam_tri_t[torch.as_tensor(arow, device=dev)])  # [Tv, B|1]
    a = gram_t.new_zeros((b, k, k))
    a[:, i_t, j_t] = (base + alpha * gram_t[:len(ii)]).t()
    return a


def tri_combine_solve_sample_ref(gram_t, lam, rhs_t, noise_t, alpha,
                                 lam_tri_t=None, grouped=False):
    """Plain PyTorch version of :func:`tri_combine_solve_sample`:
    :func:`tri_combine`, then ``torch.linalg`` Cholesky and triangular
    solves.  A non-positive-definite system gives NaN, as the JAX kernel
    does."""
    chol = cholesky_or_nan(tri_combine(gram_t, lam, alpha, lam_tri_t, grouped))
    y = torch.linalg.solve_triangular(chol, rhs_t.t()[..., None], upper=False)
    y = y + noise_t.t()[..., None]
    u = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return u[..., 0].t()


def chol_solve_sample_pallas_blast(
    precision: torch.Tensor,  # [B, K, K] SPD, lower triangle read
    rhs: torch.Tensor,        # [B, K]
    noise: torch.Tensor,      # [B, K]
) -> torch.Tensor:
    """u [B, K] = L' \\ (L \\ rhs + noise), L L' = precision: the signature
    of ``bpmf_tpu.ops.pallas_solve.chol_solve_sample_pallas_blast``.  Beyond
    the TPU kernel's VMEM budget (K > 106) it runs the ``vpu`` chain, as
    the JAX function does.  Otherwise CPU tensors take
    :func:`chol_solve_sample_pallas_blast_ref`, CUDA tensors the kernel
    (float32 only); nothing falls back."""
    b, k, _ = precision.shape
    if tuple(precision.shape) != (b, k, k):
        raise ValueError(f"precision has shape {tuple(precision.shape)}, "
                         "expected [B, K, K]")
    for name, t in (("rhs", rhs), ("noise", noise)):
        if tuple(t.shape) != (b, k):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, k)}")
        if t.device != precision.device or t.dtype != precision.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, precision "
                             f"{precision.dtype} on {precision.device}")
    if not smart_uses_kernel(k):
        return chol_solve_sample_vpu(precision, rhs, noise)
    if precision.device.type == "cpu":
        return chol_solve_sample_pallas_blast_ref(precision, rhs, noise)
    if precision.device.type != "cuda":
        raise ValueError(f"chol_solve_sample_pallas_blast: no kernel for "
                         f"{precision.device}")
    if precision.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel is float32-only, got {precision.dtype}")
    prec, r, n = (t.contiguous() for t in (precision, rhs, noise))
    out = torch.empty((b, k), dtype=torch.float32, device=prec.device)
    err = _blast_kernel()(prec.data_ptr(), r.data_ptr(), n.data_ptr(), k, b,
                          out.data_ptr(),
                          torch.cuda.current_stream(prec.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"chol_solve_sample kernel launch failed: cudaError {err}")
    solve_launches["blast"] += 1
    return out


# The batched solve's (#8) register-solve capacities; a K past the last
# runs on the panels, three rows a lane up to 96, four past it
BLAST_CAPACITIES = (8, 16, 24, 32, 48, 64)
SMEM_PER_SM = 227 * 1024  # an H100 SM's shared memory a block may use


def blast_instance(k: int) -> tuple[int, int, int]:
    """(capacity, rows a lane, items a block) of the instance #8 launches
    at K <= 106: the register solve at the next capacity of
    :data:`BLAST_CAPACITIES` (capacity 0: the panels, K 65-106), and 8
    items a block (a warp each) while two blocks of 8 fit an SM's shared
    memory, else 4.  A copy of ``csrc/chol_solve_sample.cu``'s
    ``instance_of``, which ``bpmf_chol_solve_instance`` reports on the
    card."""
    if not 1 <= k <= 106:
        raise ValueError(f"K={k} is outside the kernel's gate (1..106)")
    tv4 = -(-(k * (k + 1) // 2) // 4) * 4           # round4(K(K+1)/2)
    kp = next((c for c in BLAST_CAPACITIES if c >= k), 0)
    if kp:
        rows = -(-kp // 32)
        q = kp // 4
        area = max(tv4, kp * kp - 8 * q * (q - 1))   # lcol_floats(kp)
    else:
        rows = 3 if k <= 96 else 4
        area = tv4 + 8 * k                           # the panel buffer
    return kp, rows, 8 if 2 * 4 * 8 * area + 2048 <= SMEM_PER_SM else 4


@functools.cache
def _blast_kernel():
    """The built kernel's C entry point (built on first use)."""
    from bpmf_tpu_torch.ops._build import load

    fn = load("chol_solve_sample").bpmf_chol_solve_sample
    p = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p, p]
    return fn


def chol_solve_sample_pallas_blast_ref(precision, rhs, noise):
    """Plain PyTorch version of :func:`chol_solve_sample_pallas_blast`: the
    TPU kernel's math (``_kernel_blast_inplace``: right-looking Cholesky by
    rsqrt column scaling, lower triangle only, both substitutions and the
    draw) is the ``vpu`` chain's, here in float32 as the kernel computes,
    cast back to the input dtype."""
    f32 = torch.float32
    return chol_solve_sample_vpu(precision.to(f32), rhs.to(f32),
                                 noise.to(f32)).to(precision.dtype)
