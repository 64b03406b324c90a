"""dense8 half-sweep: rating codes (int8, int16 past 127 levels), routing,
and its kernels.

Host part: numpy copies of the JAX package's code-array helpers, layouts
and routing gates (``bpmf_tpu/ops/dense8.py:70-230, 317-336, 477-506``).
They are copied, not imported, because that module imports jax at the top
and a GPU deployment need not have it; ``tests/test_torch_layout.py`` pins
each copy to its original.  :func:`d8_route` decides each side's route.

Device part, two routes:

* the megakernel :func:`dense8_sweep_solve`: the whole half-sweep compute
  (Gram and rhs from the codes, prior combine, Cholesky, both
  substitutions, the draw) as one hand-written CUDA kernel
  (``csrc/dense8_sweep_solve.cu``), with the packed-triangle products
  formed in the kernel (#1) or streamed from a hoisted operand
  :func:`packed_tri_t` in the tight or the 8-aligned layout (#2); on bf16
  operands at K <= 32 either a dense tensor-core kernel
  (``csrc/dense8_sweep_solve_mma.cu``, launch by :func:`sweep_mma_plan`)
  or the walk's bf16 instances, by the two kernels' cost models
  (:func:`sweep_bf16_kernel`);
* the first stage of the split pipeline, :func:`dense8_gram_rhs_rows` /
  :func:`dense8_gram_rhs_cols`: the packed Gram and the rhs only, then
  ``ops/pallas_solve`` solves.  On float32 operands a sparse walk over the
  rated entries (``csrc/dense8_gram_rhs.cu``; the frozen axis in segments,
  the in-kernel products by :func:`sweep_plan` as the megakernel does, the
  hoisted operand by :func:`hoisted_plan`); on bf16 operands one dense
  tensor-core product over the code tiles for both (``csrc/
  dense8_gram_mma.cu``; tiles and segments by :func:`mma_plan`).

Each has a plain PyTorch version (``*_ref``).  A wrapper runs the plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.  The frozen items ``v_t`` and the hoisted operand ``p_t`` are
float32, or bf16 (``Config.matmul_dtype="bfloat16"``), which takes the
megakernel's bf16 instances (``csrc/dense8_sweep_solve_bf16.cu``) and the
tensor-core Gram, in libraries of their own, and rounds where the JAX
package's kernels round: #1/#3 each product of two entries of v, #2/#4
the fold's rhs weights cs*v and cb*v (cs and cb rounded first); every sum
is float32.  A bf16 tensor never reaches a float32 instance.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bpmf_tpu_torch.ops.mvnormal import cholesky_or_nan
from bpmf_tpu_torch.ops.pallas_solve import (
    tight_rows,
    tri_fused_supported,
    tri_offsets,
    tri_tight_pairs,
)

__all__ = [
    "BLOCK_MULTIPLE",
    "HOISTED_K",
    "Quantization",
    "quantize_values",
    "build_code_array",
    "solve_fused_mode",
    "solve_fused_supported",
    "pt_mode",
    "d8_route",
    "packed_tri_t",
    "dense8_gram_rhs_rows",
    "dense8_gram_rhs_cols",
    "dense8_gram_rhs_ref",
    "dense8_sweep_solve",
    "dense8_sweep_solve_ref",
    "sweep_plan",
    "hoisted_plan",
    "mma_plan",
    "sweep_mma_plan",
    "sweep_bf16_kernel",
    "sweep_walk_us",
    "walk_work",
]

BLOCK_MULTIPLE = 512  # both sides' padded_num must be a multiple of this
# The megakernel's instances: #1 (products built in the kernel) for the
# lane capacities of one warp, one row a lane up to 32 and two past it, so
# every K the JAX package fuses (solve_fused_supported: K <= 41) runs on the
# next capacity up; #2 (a hoisted operand) with its layout's offsets fixed
# at HOISTED_K, and at any other K on the next capacity with a runtime K.
INKERNEL_CAPACITIES = (8, 16, 24, 32, 40, 44)
HOISTED_K = (16, 32)
HOISTED_MAX_ROWS = 128 * 26  # gram_rhs_hoisted: 32 lanes x 26 float4 sums
# The in-kernel Gram's (#3) register-row instances; past the last, K runs
# on 4x4 tiles
GRAM_ROW_CAPACITIES = (16, 32, 48, 64)


def gram_row_floats(k: int) -> int:
    """Floats per row of v that #3 reads: its register-row instance's
    capacity (K <= 64), else K rounded up to 4 (the tile instance); the
    wrapper pads v's rows with zeros to it."""
    return next((c for c in GRAM_ROW_CAPACITIES if c >= k), -(-k // 4) * 4)

# the operand types of the kernels, and the suffix of their counters' keys
OPERAND_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
# CUDA launches, counted where they launch (plain-version calls are not):
# the megakernel by its operand (#1 'inkernel', #2 'tight' or 'aligned'),
# the Gram kernels (#3 'inkernel', #4 'hoisted'), and the megakernel by
# instance (sweep_instance_key).  A launch on bf16 operands (the
# megakernel's bf16 instances, the tensor-core Gram) counts under the
# float32 key with OPERAND_SUFFIX's "_bf16".
sweep_launches = {o + s: 0 for s in OPERAND_SUFFIX.values()
                  for o in ("inkernel", "tight", "aligned")}
gram_launches = {o + s: 0 for s in OPERAND_SUFFIX.values()
                 for o in ("inkernel", "hoisted")}
sweep_instance_launches: dict = {}


def _operand_suffix(*tensors) -> str:
    """The counter-key suffix of the kernel instance for operands of one
    type (float32 or bf16); raises on mixed or other types."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) != 1 or not dtypes <= set(OPERAND_SUFFIX):
        raise ValueError("the CUDA kernels take float32 or bf16 operands of one "
                         f"type, got {sorted(map(str, dtypes))}")
    return OPERAND_SUFFIX[dtypes.pop()]


def _compute_dtype(v_t: torch.Tensor) -> torch.dtype:
    """The dtype the sums and the solve run in: float32 for bf16 operands,
    else the operands' own."""
    return torch.float32 if v_t.dtype == torch.bfloat16 else v_t.dtype


def fold_weights(v_t: torch.Tensor, cs: float, cb: float):
    """(bf16(cs v), bf16(cb v)) as float32, cs and cb rounded to bf16
    first: the rhs weights of the JAX package's hoisted kernels (#2, #4)
    under its default fold (``v_t * v_t.dtype.type(cs)``), for bf16 v."""
    v = v_t.float()
    bf = torch.bfloat16
    return tuple((v * float(torch.tensor(c).to(bf))).to(bf).float() for c in (cs, cb))


class Quantization(NamedTuple):
    """value = offset + scale * code, code in 1..levels (0 = absent)."""

    offset: float
    scale: float
    levels: int


def quantize_values(vals: np.ndarray, max_levels: int = 255) -> Optional[Quantization]:
    """The exact affine coding of ratings on a small uniform grid, or None.

    Copy of ``bpmf_tpu.ops.dense8.quantize_values``: exactness is verified
    in float32, so decoding a code reproduces the rating bit for bit."""
    if vals.size == 0:
        return None
    uniq = np.unique(vals.astype(np.float64))
    if len(uniq) > max_levels:
        return None
    if len(uniq) == 1:
        scale = 1.0
    else:
        diffs = np.diff(uniq)
        scale = float(diffs.min())
        if scale <= 0:
            return None
        steps = diffs / scale
        if not np.allclose(steps, np.round(steps), atol=1e-9):
            return None
        if np.round((uniq[-1] - uniq[0]) / scale) >= max_levels:
            return None
    offset = float(uniq[0] - scale)  # code 1 -> uniq[0]
    codes = np.round((uniq - offset) / scale)
    dec = np.float32(offset) + np.float32(scale) * codes.astype(np.float32)
    if not np.array_equal(dec, uniq.astype(np.float32)):
        return None
    return Quantization(offset=offset, scale=scale, levels=int(codes[-1]))


def build_code_array(
    coo_rows: np.ndarray,
    coo_cols: np.ndarray,
    coo_vals: np.ndarray,
    q: Quantization,
    rows_pad: int,
    cols_pad: int,
) -> np.ndarray:
    """[rows_pad, cols_pad] int8 (int16 beyond 127 levels) rating codes;
    absent entries are 0.  Indices are in the padded order of their sides.
    Copy of ``bpmf_tpu.ops.dense8.build_code_array``."""
    dt = np.int8 if q.levels <= 127 else np.int16
    codes = np.zeros((rows_pad, cols_pad), dt)
    c = np.round((coo_vals - q.offset) / q.scale).astype(dt)
    codes[coo_rows, coo_cols] = c
    return codes


# -- layouts and routing (copies of the JAX package's) --------------------

@functools.cache
def _aligned_pairs(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ii, jj) of the 8-aligned bottom-padded packed triangle.  Copy of
    ``bpmf_tpu.ops.dense8._aligned_pairs``."""
    offs, t_total = tri_offsets(k)
    ii = np.zeros(t_total, np.int32)
    jj = np.zeros(t_total, np.int32)
    for j in range(k):
        ii[offs[j]: offs[j] + (k - j)] = np.arange(j, k)
        jj[offs[j]: offs[j] + (k - j)] = j
    return ii, jj


def _tight_offsets(k: int) -> list[int]:
    """Row offset of column j's segment in the tight packed triangle,
    j*k - j(j-1)/2.  Copy of ``bpmf_tpu.ops.dense8._tight_offsets``."""
    toff, t = [], 0
    for j in range(k):
        toff.append(t)
        t += k - j
    return toff


def solve_fused_mode(value: str = "fused") -> str:
    """The route a ``BPMF_D8_SOLVE`` value selects: 'tight' (the default
    megakernel), 'aligned' (``fused_aligned``) or 'split' (any other
    value), as ``bpmf_tpu.ops.dense8.solve_fused_mode`` maps it."""
    return {"fused": "tight", "fused_aligned": "aligned"}.get(value, "split")


@functools.cache
def solve_fused_supported(k: int, layout: str = "aligned") -> bool:
    """The JAX package's VMEM gate for its megakernel (K <= 41 tight, 39
    aligned), copied because it decides the route.  Copy of
    ``bpmf_tpu.ops.dense8.solve_fused_supported``."""
    if layout == "aligned":
        _, t = tri_offsets(k)
    else:
        t = _tight_offsets(k)[-1] + 1
    t_in = t + k
    ob, nb = 512, 1024
    scratch = (t_in + k) * ob * 4
    solve_live = 2 * k * k * ob * 4
    operands = 2 * (t_in * nb * 2 + ob * nb)
    return scratch + solve_live + operands <= 13 * 1024 * 1024


def _pick_block(n: int, prefer: tuple[int, ...] = (1024, 512)) -> int:
    for b in prefer:
        if n % b == 0:
            return b
    raise ValueError(f"dense8 dimension {n} not a multiple of {BLOCK_MULTIPLE}")


def _blocks(items: int, frozen: int, prefer_items: tuple[int, ...],
            prefer_frozen: tuple[int, ...]) -> tuple[int, int]:
    """(item_block, contraction_block) of the TPU kernels' grids.  Copy of
    ``bpmf_tpu.ops.dense8._blocks`` without its ``BPMF_D8_BLOCKS`` knob,
    which tunes TPU block sizes that the port's kernels do not have."""
    return _pick_block(items, prefer_items), _pick_block(frozen, prefer_frozen)


def pt_mode(items: int, frozen: int, k: int, fused: bool, orientation: str,
            pt: str = "auto") -> str:
    """'inkernel' or 'hoisted': where the packed-triangle operand is built.
    Copy of ``bpmf_tpu.ops.dense8.pt_mode``, with the ``BPMF_D8_PT`` value
    passed in as ``pt``.  Its cost constants were measured on a TPU; the
    port keeps them so that it takes the JAX package's route (whether they
    suit the card is ROADMAP.md Queue 2 B7)."""
    if pt in ("inkernel", "hoisted"):
        return pt
    if fused:
        prefer_items = (512,)
    elif orientation == "rows":
        prefer_items = (1024, 512)
    else:
        prefer_items = (512, 1024)
    item_block, _ = _blocks(items, frozen, prefer_items, (1024, 512))
    t = k * (k + 1) // 2 + k
    n_blocks = max(1, items // item_block)
    inkernel_ms = 2 * t * k * frozen * n_blocks * 2 / 52e9
    hoisted_ms = (t * frozen * 2 / 69e6
                  + t * frozen * 2 * n_blocks / 819e6)
    return "inkernel" if inkernel_ms < hoisted_ms else "hoisted"


FUSED_ROUTES = ("fused", "fused_hoisted", "fused_aligned")  # megakernel
SWEEP_LAYOUT = {"fused_hoisted": "tight", "fused_aligned": "aligned"}


def d8_route(k: int, items: int, frozen: int, orientation: str, *,
             peritem: bool = False, solve: str = "fused",
             pt: str = "auto") -> str:
    """One dense8 side's route: the megakernel :func:`dense8_sweep_solve`
    with the packed operand built in the kernel ('fused', #1) or streamed
    from :func:`packed_tri_t` in the tight ('fused_hoisted') or the
    8-aligned layout ('fused_aligned', #2), or the split pipeline with the
    packed operand built in the Gram kernel ('inkernel') or hoisted out of
    it ('hoisted').  ``solve`` and ``pt`` are the ``BPMF_D8_SOLVE`` and
    ``BPMF_D8_PT`` values, read once at setup.

    The decision is the JAX package's (``parallel/spmd.py:846-892``) at
    every K: a fused side (K <= 41 in the tight layout, 39 in the aligned
    one, :func:`solve_fused_supported`; no per-item prior) streams the
    aligned operand under ``BPMF_D8_SOLVE=fused_aligned``, else the tight
    one where :func:`pt_mode` says hoisted (``BPMF_D8_PT=hoisted``, or from
    759,808 padded items at K=32, fewer past it), else builds it in the
    kernel; any other side takes the split pipeline, its Gram's operand by
    :func:`pt_mode`.  The CPU takes the same route as the card, so the CPU
    tests run the card's route.  The fused and split routes differ only in
    rounding (``tests/test_dense8.py:264-291`` holds them to 1e-5 on
    rmse)."""
    if not tri_fused_supported(k, peritem):
        raise ValueError(f"K={k} is beyond the dense8 gate (tri_fused_supported)")
    layout = solve_fused_mode(solve)
    if layout != "split" and solve_fused_supported(k, layout) and not peritem:
        if layout == "aligned":
            return "fused_aligned"
        if pt_mode(items, frozen, k, True, orientation, pt) == "hoisted":
            return "fused_hoisted"
        return "fused"
    return pt_mode(items, frozen, k, False, orientation, pt)


@functools.cache
def _pair_index(k: int, aligned: bool, device: torch.device):
    """(ii, jj) of the tight (:func:`tri_tight_pairs`) or the aligned
    (:func:`_aligned_pairs`) layout as index tensors on ``device``."""
    pairs = _aligned_pairs(k) if aligned else tri_tight_pairs(k)[:2]
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in pairs)


@functools.cache
def _layout_rows(k: int, layout: str):
    """(rows, ii, jj): the valid rows of the 'tight' or 'aligned' packed
    layout and the lower-triangle entry (ii, jj) each holds."""
    if layout == "aligned":
        ii, jj = _aligned_pairs(k)
        offs, _ = tri_offsets(k)
        rows = np.concatenate([np.arange(offs[j], offs[j] + k - j)
                               for j in range(k)])
    else:
        ii, jj, _ = tri_tight_pairs(k)
        rows = np.arange(k * (k + 1) // 2)
    return rows, ii[rows], jj[rows]


def packed_tri_t(v_t: torch.Tensor, aligned: bool = False) -> torch.Tensor:
    """[K, N] frozen items (transposed) -> [T, N] packed lower-triangle
    products, p_t[t, n] = v_t[ii[t], n] * v_t[jj[t], n]
    (``bpmf_tpu.ops.dense8.packed_tri_t``): the tight layout with (0, 0)
    padding rows (T = 528 at K=32), or with ``aligned`` the 8-aligned
    bottom-padded one (T = 640 at K=32), whose padding rows also hold the
    (0, 0) product v[0]*v[0], as the JAX package's do; no kernel reads
    them.  The result is the transposed view of an item-major [N, T]
    tensor, the layout the kernels read."""
    ii, jj = _pair_index(v_t.shape[0], aligned, v_t.device)
    v = v_t.t()
    return (v.index_select(1, ii) * v.index_select(1, jj)).t()


# -- kernel wrappers ------------------------------------------------------

def _check_codes(codes, orientation):
    if orientation not in ("rows", "cols"):
        raise ValueError(f"orientation must be 'rows' or 'cols', got {orientation!r}")
    if codes.dtype not in (torch.int8, torch.int16):  # build_code_array's
        raise ValueError(f"dense8 codes must be int8 or int16, got {codes.dtype}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got shape {tuple(codes.shape)}")
    r, c = codes.shape
    if r % BLOCK_MULTIPLE or c % BLOCK_MULTIPLE:
        raise ValueError(
            f"dense8 code array {r}x{c}: both sides must be multiples of "
            f"{BLOCK_MULTIPLE}")
    return (r, c) if orientation == "rows" else (c, r)


def _gram_rhs(codes, p_t, v_t, cs, cb, orientation, max_degree):
    """dense8_gram_rhs_rows/cols: the plain version for CPU tensors, else
    the kernel."""
    items, frozen = _check_codes(codes, orientation)
    k = v_t.shape[0]
    if tuple(v_t.shape) != (k, frozen):
        raise ValueError(f"v_t has shape {tuple(v_t.shape)}, expected ({k}, {frozen})")
    if p_t is not None and p_t.shape[1] != frozen:
        raise ValueError(f"p_t has shape {tuple(p_t.shape)}, expected (T, {frozen})")
    for name, t in (("v_t", v_t), ("p_t", p_t)):
        if t is not None and t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on {codes.device}")
    if max_degree is not None and not 0 <= int(max_degree) <= frozen:
        raise ValueError(f"max_degree={max_degree}: an item has at most {frozen} "
                         "ratings on this side")
    if p_t is not None and p_t.dtype != v_t.dtype:
        raise ValueError(f"p_t is {p_t.dtype}, v_t {v_t.dtype}")
    if codes.device.type == "cpu":
        return dense8_gram_rhs_ref(codes, p_t, v_t, cs, cb, orientation)
    if codes.device.type != "cuda":
        raise ValueError(f"dense8_gram_rhs: no kernel for device {codes.device}")
    suffix = _operand_suffix(v_t, p_t)
    if not tri_fused_supported(k):
        raise ValueError(f"K={k} is beyond the dense8 gate (tri_fused_supported)")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (row-major)")
    if codes.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary (cp.async)")
    if suffix:
        return _gram_rhs_mma(codes, p_t, v_t, cs, cb, orientation, items, frozen)
    dev = codes.device
    partial = arrivals = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p_t is None:
        # #3: v's rows zero-padded to its instance's width (16-byte copies)
        kv = gram_row_floats(k)
        v = F.pad(v_t.t(), (0, kv - k)).contiguous()          # [N, KV]
        t_out, p = tight_rows(k), None
        plan = sweep_plan(items, frozen, k, max_degree, _sm_count(dev))
    else:
        kv, v, p = k, v_t.t().contiguous(), _hoisted_rows(p_t)  # [N, K], [N, T]
        t_out = p.shape[1]
        plan = hoisted_plan(items, frozen, t_out, k, max_degree, _sm_count(dev))
    if plan.segments > 1:
        partial = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
        arrivals = _arrival_counters(dev, stream, plan.counters)
    gram = torch.empty((items, t_out), dtype=torch.float32, device=dev)
    rhs = torch.empty((items, k), dtype=torch.float32, device=dev)
    r, c = codes.shape
    err = _gram_kernel()(
        codes.data_ptr(), codes.element_size(), r, c, int(orientation == "rows"),
        k, v.data_ptr(), kv, None if p is None else p.data_ptr(), t_out, cs, cb,
        plan.segments, plan.tiles_per_segment,
        None if partial is None else partial.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        gram.data_ptr(), rhs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense8_gram_rhs kernel launch failed: cudaError {err}")
    gram_launches["hoisted" if p is not None else "inkernel"] += 1
    return gram.t(), rhs.t()


def _gram_rhs_mma(codes, p_t, v_t, cs, cb, orientation, items, frozen):
    """dense8_gram_rhs_rows/cols on bf16 CUDA operands: the tensor-core
    kernel (``csrc/dense8_gram_mma.cu``) on :func:`mma_plan`'s tiles and
    segments, #3 (``p_t`` None: the tight products formed in the kernel)
    or #4 (``p_t``'s every row summed), counted under ``gram_launches``'
    ``_bf16`` keys."""
    k = v_t.shape[0]
    dev = codes.device
    v = v_t.contiguous()          # [K, N]: the kernel stages v_t's rows
    if v.data_ptr() % 16:
        v = v.clone()
    if p_t is None:
        t_out, p = tight_rows(k), None
    else:
        p = _hoisted_rows(p_t)                 # [N, T]
        t_out = p.shape[1]
    plan = mma_plan(items, frozen, t_out, k, _sm_count(dev),
                    code_bytes=codes.element_size())
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = arrivals = None
    if plan.segments > 1:
        partial = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
        arrivals = _arrival_counters(dev, stream, plan.counters)
    gram = torch.empty((items, t_out), dtype=torch.float32, device=dev)
    rhs = torch.empty((items, k), dtype=torch.float32, device=dev)
    r, c = codes.shape
    err = _mma_kernel()(
        codes.data_ptr(), codes.element_size(), r, c, int(orientation == "rows"),
        k, v.data_ptr(), None if p is None else p.data_ptr(), t_out, cs, cb,
        plan.segments, plan.chunks_per_segment, plan.smem_bytes,
        None if partial is None else partial.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        gram.data_ptr(), rhs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense8_gram_mma kernel launch failed: cudaError {err}")
    gram_launches[("hoisted" if p is not None else "inkernel") + "_bf16"] += 1
    return gram.t(), rhs.t()


def _hoisted_rows(p_t: torch.Tensor) -> torch.Tensor:
    """p_t [T, N] as the row-major [N, T] tensor #4 reads: its transposed
    view, with no copy when p_t is one (as :func:`packed_tri_t` gives);
    a batch-last p_t is copied.  Refuses a T the kernel has no instance
    for (a multiple of 4 up to :data:`HOISTED_MAX_ROWS`: its rows are read
    as float4s) and rows off a 16-byte boundary."""
    t = p_t.shape[0]
    if t > HOISTED_MAX_ROWS or t % 4:
        raise ValueError(f"p_t has {t} rows; the kernel takes a multiple of 4 "
                         f"up to {HOISTED_MAX_ROWS}")
    p = p_t.t()
    if not p.is_contiguous():
        p = p.contiguous()
    if p.data_ptr() % 16:
        raise ValueError("p_t's rows must start on a 16-byte boundary")
    return p


@functools.cache
def _gram_kernel():
    """The float32 Gram kernels' C entry point (built on first use)."""
    from bpmf_tpu_torch.ops._build import load

    fn = load("dense8_gram_rhs").bpmf_dense8_gram_rhs
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, p, i, p, i, f, f, i, i, p, p, p, p, p]
    return fn


@functools.cache
def _mma_kernel():
    """The tensor-core Gram's C entry point, bf16 operands (built on first
    use)."""
    from bpmf_tpu_torch.ops._build import load

    fn = load("dense8_gram_mma").bpmf_dense8_gram_mma
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, p, p, i, f, f, i, i, i, p, p, p, p, p]
    return fn


def dense8_gram_rhs_rows(codes: torch.Tensor, p_t: Optional[torch.Tensor],
                         v_t: torch.Tensor, cs: float, cb: float, *,
                         max_degree: Optional[int] = None):
    """gram_t [T, R] and rhs_t [K, R] f32 for the side whose items are the
    code ROWS, batch-last (``bpmf_tpu.ops.dense8.dense8_gram_rhs_rows``),
    from int8 or int16 codes.
    ``p_t=None`` builds the packed products in the kernel (tight layout,
    T = roundup(K(K+1)/2, 16), padding rows zero); a given ``p_t``
    [T, C] (:func:`packed_tri_t`) is summed as it is.

    The JAX package's ``BPMF_D8_FOLD`` (the cb-term riding the Gram as K
    extra rows, which saves the TPU an MXU pass) has no counterpart at
    float32: it changes only rounding, and the kernel forms cs*code + cb
    per rating on both routes; on bf16 operands #3's rhs is
    cs*(code@v) + cb*(ind@v) and #4's code@bf16(cs v) + ind@bf16(cb v),
    as the JAX kernels and its default fold form them (:func:`fold_weights`).  CPU tensors take
    :func:`dense8_gram_rhs_ref`; CUDA tensors the kernel (float32 or bf16 ``v_t`` and ``p_t`` of one type, K
    within the dense8 gate, codes on a 16-byte boundary).  Outputs are
    float32; on the card the transposed views of item-major tensors.

    On float32 operands both kernels walk the rated entries and split the
    frozen axis into segments, from ``max_degree`` (the most ratings any
    item of this side has, at most the frozen count; the sampler passes
    it) or from the shape alone: the in-kernel products (#3) by
    :func:`sweep_plan`, the hoisted operand (#4) by :func:`hoisted_plan`,
    which also keeps a segment's rows of ``p_t`` within L2.  On bf16
    operands one tensor-core kernel multiplies the whole code array, dense
    as the TPU kernels do (``max_degree`` is not needed), on
    :func:`mma_plan`'s tiles and segments.  The result is the same bit for
    bit from launch to launch.  #4 reads ``p_t`` as the transposed view of
    an item-major [C, T] tensor, which :func:`packed_tri_t` gives, with no
    copy; it takes T a multiple of 4 up to :data:`HOISTED_MAX_ROWS`."""
    return _gram_rhs(codes, p_t, v_t, cs, cb, "rows", max_degree)


def dense8_gram_rhs_cols(codes: torch.Tensor, p_t: Optional[torch.Tensor],
                         v_t: torch.Tensor, cs: float, cb: float, *,
                         max_degree: Optional[int] = None):
    """As :func:`dense8_gram_rhs_rows` for the side whose items are the code
    COLUMNS: gram_t [T, C], rhs_t [K, C]."""
    return _gram_rhs(codes, p_t, v_t, cs, cb, "cols", max_degree)


def dense8_gram_rhs_ref(codes, p_t, v_t, cs, cb, orientation):
    """Plain PyTorch version of :func:`dense8_gram_rhs_rows` /
    :func:`dense8_gram_rhs_cols`: gram_t = p @ ind and rhs_t =
    v_t @ (cs*code + cb*ind) as dense matmuls over the whole code array,
    with p built from ``v_t`` in the tight layout (padding rows zero) when
    ``p_t`` is None.  bf16 operands round as the JAX package's kernels do,
    and every product and sum is float32: each built product to bf16
    (#3), and given a ``p_t`` (#4) the rhs as the fold's
    (:func:`fold_weights`)."""
    dtype = _compute_dtype(v_t)
    bf16 = v_t.dtype == torch.bfloat16
    k = v_t.shape[0]
    x = codes if orientation == "rows" else codes.t()    # [items, N]
    ind = (x != 0).to(dtype)
    cv = x.to(dtype)
    v = v_t.to(dtype)
    if p_t is None:
        ii, jj = _pair_index(k, False, v_t.device)
        tv = k * (k + 1) // 2
        gram_t = ind.new_zeros((len(ii), x.shape[0]))
        p = v[ii[:tv]] * v[jj[:tv]]
        gram_t[:tv] = (p.to(torch.bfloat16).to(dtype) if bf16 else p) @ ind.t()
    else:
        gram_t = p_t.to(dtype) @ ind.t()
    if bf16 and p_t is not None:
        ws, wb = fold_weights(v_t, cs, cb)
        rhs_t = ws @ cv.t() + wb @ ind.t()
    else:
        rhs_t = cs * (v @ cv.t()) + cb * (v @ ind.t())
    return gram_t, rhs_t


def _check_args(codes, v_t, lam, prior_rhs, noise_t, orientation):
    items, frozen = _check_codes(codes, orientation)
    k = v_t.shape[0]
    dtype = _compute_dtype(v_t)
    want = {"v_t": (k, frozen), "lam": (k, k), "prior_rhs": (k, 1),
            "noise_t": (k, items)}
    for name, t in (("v_t", v_t), ("lam", lam), ("prior_rhs", prior_rhs),
                    ("noise_t", noise_t)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on {codes.device}")
        if name != "v_t" and t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, v_t is {v_t.dtype}: "
                             f"expected {dtype}")
    return items, k


def _sweep_rows(k: int, layout: str) -> int:
    """Rows of the hoisted operand #2 reads in ``layout``."""
    return tight_rows(k) if layout == "tight" else tri_offsets(k)[1]


ITEMS_PER_BLOCK = 8       # the megakernel's items per block (a warp each)
BLOCKS_PER_SM = 2         # ... and its blocks resident on one SM
SEGMENT_RATINGS = 2048    # at most this many of the most-rated item's
                          # ratings in one segment of the frozen axis
SCRATCH_LIMIT_BYTES = 1 << 30  # the segments' partial sums at most
MMA_ITEMS = 128       # the tensor-core Gram's block: items (mma rows),
MMA_COLS = 128        # output columns,
MMA_CHUNK = 64        # frozen entries a step,
MMA_RHS = 64          # rhs entries a column tile (64 columns each on the
                      # codes and on the indicator),
MMA_STAGES = (4, 3)   # stages of codes and of p's rows (int8, int16 codes),
MMA_BLOCKS_PER_SM = 2  # and blocks resident on one SM
HOISTED_SEGMENT_RATINGS = 512  # #4 reads one rated row of p at a time a
                               # warp, so it takes fewer of the most-rated
                               # item's ratings a segment than SEGMENT_RATINGS
HOISTED_L2_BYTES = 40 << 20  # #4: at most this much of p's rows under the
                             # blocks in flight, so they stay in an H100's
                             # 50 MB L2 beside the Gram's writes
MMA_SWEEP_CAPACITIES = (8, 16, 24, 32)  # the tensor-core megakernel's K
MMA_SWEEP_ITEMS = 128   # its block's items (two warpgroups of wgmma's 64),
MMA_SWEEP_UNITS = 2     # column units (64 Gram columns, or the rhs) both
                        # consumer warpgroups hold,
MMA_SWEEP_WARPS = 16    # its warps (two warpgroups produce), a block an SM,
MMA_SWEEP_STAGES = (4, 3)  # stages (int8, int16 codes)
# Both megakernels' times on bf16 operands by a model, in microseconds,
# fitted (least squares on the relative error) to their times per launch
# at [6144, 4096] (K 8/16/24/32, random codes 0-16% rated) and on chains'
# own state at K=32 (ml-1m, ml-100k's and Jester's scale, a dense synth,
# chembl; ml-25M half for the tensor cores) (sweep_times.py --legs
# mega_bf16 and bf16_choice, H100 80GB HBM3, 700 W).  The tensor-core
# kernel's (sweep_mma_plan, which also picks its segment count by it): a
# launch, then the waves of blocks times a block's chunks (a fixed part
# and a part per Gram tile the block holds) and its fixed work (prologue,
# partials, wait, its share of the solves).  The walk's (sweep_walk_us): a
# launch, an item (its solve), a code entry (the scan) and an entry of its
# work (walk_work: a warp an item, so a block of items is as slow as its
# most-rated), the last by operand and capacity, and WALK_P_MISS more for
# #2 when p's rows pass HOISTED_L2_BYTES.
MMA_SWEEP_LAUNCH_US = 8.3
MMA_SWEEP_CHUNK_US = 0.129
MMA_SWEEP_TILE_US = 0.456
MMA_SWEEP_BLOCK_US = 25.0
WALK_LAUNCH_US = 25.8
WALK_ITEM_US = 2.18e-3
WALK_ENTRY_US = 7.75e-7
WALK_RATING_US = {
    "inkernel": {8: 3.41e-5, 16: 6.88e-5, 24: 1.003e-4, 32: 1.098e-4},
    "tight": {8: 8.03e-5, 16: 8.04e-5, 24: 1.662e-4, 32: 1.358e-4},
    "aligned": {8: 9.59e-5, 16: 1.552e-4, 24: 3.625e-4, 32: 1.960e-4}}
WALK_P_MISS = 0.7
MMA_SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


class SweepPlan(NamedTuple):
    """How a kernel splits the frozen axis (:func:`sweep_plan`,
    :func:`hoisted_plan`)."""

    segments: int           # S: blocks per item block
    tiles_per_segment: int  # 512-entry tiles each segment sums
    scratch_shape: tuple    # the partial sums [S, items, floats an item], or ()
    counters: int           # arrival counters, one per item block, or 0


def sweep_plan(items: int, frozen: int, k: int, max_degree: Optional[int] = None,
               sms: int = 132) -> SweepPlan:
    """The segment count S of the megakernel (#1/#2) and of the in-kernel
    Gram (#3), both blocks of 8 items two to an SM, for ``items`` items of
    capacity ``k`` (for #3, any K of the dense8 gate) over ``frozen`` frozen
    entries (both multiples of 512) on a card of ``sms`` SMs.  S is the smallest count that gives at least two waves
    of blocks (``items / 8 * S >= 2 * 2 * sms``, two blocks to an SM)
    and, given the side's ``max_degree``, puts at most
    :data:`SEGMENT_RATINGS` of the most-rated item's ratings in one
    segment; it is capped by the 512-entry tiles and by a scratch of
    :data:`SCRATCH_LIMIT_BYTES`, then evened out so that every segment
    holds ``tiles_per_segment`` tiles but the last, which holds at least
    one.  Without ``max_degree`` S comes from the shape alone."""
    return _segment_plan(items, frozen, k * (k + 1) // 2 + k, max_degree, sms)


def hoisted_plan(items: int, frozen: int, t: int, k: int,
                 max_degree: Optional[int] = None, sms: int = 132) -> SweepPlan:
    """The segment count S of the hoisted Gram (#4) on a packed operand of
    ``t`` rows: :func:`sweep_plan`'s rule (two waves of blocks, the tiles
    and the scratch as caps), with at most :data:`HOISTED_SEGMENT_RATINGS`
    of the most-rated item's ratings a segment (its warp's rows, one at a
    time, are the launch's longest chain), and besides few enough tiles a
    segment (one at least) that the rows of p (``t`` floats each) of the
    segments whose blocks run at once fit :data:`HOISTED_L2_BYTES`.  The
    segment is the grid's slow dimension, so with ``items / 8`` blocks a
    segment and two blocks an SM, ``2 * sms / (items / 8)`` segments (one
    at least) run at once.  The scratch holds an item's packed Gram and
    rhs, [S, items, t + roundup(K, 4)]."""
    at_once = -(-BLOCKS_PER_SM * sms // (items // ITEMS_PER_BLOCK))
    tiles = max(1, HOISTED_L2_BYTES // (at_once * 4 * t * BLOCK_MULTIPLE))
    return _segment_plan(items, frozen, t + -(-k // 4) * 4, max_degree, sms,
                         ratings=HOISTED_SEGMENT_RATINGS, max_tiles=tiles)


def _segment_plan(items, frozen, partial, max_degree, sms,
                  ratings=SEGMENT_RATINGS, max_tiles=None):
    """sweep_plan and hoisted_plan for an item's ``partial`` floats of
    scratch, at most ``ratings`` of the most-rated item's ratings and, where
    given, ``max_tiles`` tiles a segment."""
    tiles = frozen // BLOCK_MULTIPLE
    blocks = items // ITEMS_PER_BLOCK
    want = -(-2 * BLOCKS_PER_SM * sms // blocks)
    if max_degree:
        want = max(want, -(-int(max_degree) // ratings))
    if max_tiles:
        want = max(want, -(-tiles // max_tiles))
    cap = max(1, SCRATCH_LIMIT_BYTES // (4 * items * partial))
    per = -(-tiles // max(1, min(want, tiles, cap)))
    s = -(-tiles // per)
    if s == 1:
        return SweepPlan(1, tiles, (), 0)
    return SweepPlan(s, per, (s, items, partial), blocks)


class MmaPlan(NamedTuple):
    """The tensor-core Gram's launch (:func:`mma_plan`)."""

    item_tiles: int          # blocks of MMA_ITEMS items (grid y)
    gram_tiles: int          # column tiles of the Gram, ceil(T / MMA_COLS),
    rhs_tiles: int           # then of the rhs, ceil(K / MMA_RHS) (grid x)
    segments: int            # S: runs of the frozen axis (grid z)
    chunks_per_segment: int  # MMA_CHUNK-entry chunks each segment sums
    scratch_shape: tuple     # the partial sums [S, items, T + roundup(K, 4)], or ()
    counters: int            # arrival counters, one a tile at S > 1, or 0
    smem_bytes: int          # dynamic shared memory a block


def mma_plan(items: int, frozen: int, t: int, k: int, sms: int = 132, *,
             code_bytes: int = 2) -> MmaPlan:
    """The tiles and segments of the tensor-core Gram (bf16 #3/#4) for
    ``items`` items over ``frozen`` frozen entries (both multiples of 512),
    a Gram of ``t`` columns and K ``k``, on a card of ``sms`` SMs, with
    codes of ``code_bytes`` bytes.  A block owns MMA_ITEMS items x
    MMA_COLS columns of the Gram, or MMA_RHS entries of the rhs, over one
    segment of the frozen axis; the segment count S is the smallest that
    gives at least two waves of blocks (``tiles * S >= 2 * 2 * sms``, two
    blocks to an SM), capped by the chunks and by a scratch of
    :data:`SCRATCH_LIMIT_BYTES`, with every segment ``chunks_per_segment``
    chunks but the last, which holds at least one.  The work is dense, so
    the data's degrees do not enter.  ``smem_bytes`` is the kernel's
    layout, from its first 1 KB boundary: MMA_STAGES stages of codes (a chunk of a tile, as it lies, its
    rows padded by 16 bytes), then either as many bf16 tiles of p's
    rows or two formed bf16 B^T tiles and two stages of roundup(K, 8) rows
    of v_t (padded by 16 bytes)."""
    item_tiles = items // MMA_ITEMS
    gram_tiles, rhs_tiles = -(-t // MMA_COLS), -(-k // MMA_RHS)
    tiles = item_tiles * (gram_tiles + rhs_tiles)
    chunks = frozen // MMA_CHUNK
    part = t + -(-k // 4) * 4
    kv = -(-k // 8) * 8
    code_stage = max(MMA_ITEMS * (MMA_CHUNK * code_bytes + 16),    # rows
                     MMA_CHUNK * (MMA_ITEMS * code_bytes + 16))    # cols
    b_tile = MMA_CHUNK * MMA_COLS * 2
    stages = MMA_STAGES[code_bytes - 1]
    smem = 1024 + stages * code_stage + max(stages * b_tile,  # + 1 KB to align
                                            2 * b_tile + 2 * kv * (MMA_CHUNK + 8) * 2)
    cap = max(1, min(chunks, SCRATCH_LIMIT_BYTES // (4 * items * part)))
    want = min(cap, -(-2 * MMA_BLOCKS_PER_SM * sms // tiles))
    per = max(1, chunks // want)        # rounds S up to at least `want`
    s = -(-chunks // per)
    if s > cap:                         # ... but not past the cap
        per = -(-chunks // cap)
        s = -(-chunks // per)
    if s == 1:
        return MmaPlan(item_tiles, gram_tiles, rhs_tiles, 1, chunks, (), 0, smem)
    return MmaPlan(item_tiles, gram_tiles, rhs_tiles, s, per, (s, items, part),
                   tiles, smem)


class SweepMmaPlan(NamedTuple):
    """The tensor-core megakernel's launch (:func:`sweep_mma_plan`)."""

    item_blocks: int         # blocks of MMA_SWEEP_ITEMS items
    groups: int              # column groups: Gram tiles, then the rhs
    units_per_group: int     # Gram tiles a group holds (the last but one
                             # may hold fewer)
    segments: int            # S: runs of the frozen axis; the grid is
                             # item_blocks x groups x S blocks
    chunks_per_segment: int  # MMA_CHUNK-entry chunks each segment sums
    scratch_shape: tuple     # the partial sums [S, items, KP(KP+1)/2 + KP]
    counters: int            # int32 counters: the tickets, the blocks done,
                             # and each item block's arrivals and departures
    smem_bytes: int          # dynamic shared memory a block
    us: float                # the cost model's time of the launch


def _lcol_floats(kp: int) -> int:
    """Floats of warp_chol.cuh's column store of a factor at capacity kp."""
    return kp * kp - 8 * (kp // 4) * (kp // 4 - 1)


@functools.cache
def sweep_mma_plan(items: int, frozen: int, kp: int, t_in: Optional[int] = None,
                   sms: int = 132, *, code_bytes: int = 1) -> SweepMmaPlan:
    """The launch of the tensor-core megakernel (#1/#2 on bf16 operands,
    ``csrc/dense8_sweep_solve_mma.cu``) for ``items`` items over ``frozen``
    frozen entries (multiples of 64) at capacity ``kp`` (8, 16, 24, 32),
    #1 when ``t_in`` is None, else #2 on an operand of ``t_in`` rows, with
    codes of ``code_bytes`` bytes.  Its Gram columns (#1: kp(kp+1)/2, #2:
    t_in) make 64-column tiles, MMA_SWEEP_UNITS to a block (of
    MMA_SWEEP_ITEMS items, a block an SM), and one more block holds the
    rhs: ``groups`` blocks cover an item block.  The
    segment count S minimizes the cost model's time ``us`` (the waves of
    blocks times a block's chunks and fixed work: MMA_SWEEP_CHUNK_US and
    MMA_SWEEP_TILE_US a Gram tile, MMA_SWEEP_BLOCK_US), capped by the
    chunks, by a scratch of
    :data:`SCRATCH_LIMIT_BYTES` and by ``groups x S <= sms`` (an item
    block's blocks wait for each other, so they must fit the card at once);
    every segment holds ``chunks_per_segment`` chunks but the last, which
    holds at least one.  Every block writes its units' sums to the
    scratch; the item block's blocks then sum and solve a share of its
    items each.  ``smem_bytes`` is the kernel's layout: MMA_SWEEP_STAGES
    stages, each a chunk's codes, its Gram tiles' B (#2: p's rows; #1:
    formed), the rhs tile's B (64 columns: [wx | wy]) and kp rows of v_t;
    then a table (#1: a group's columns; #2: t_in rows); or, if
    larger, the solve's: sixteen items' summed partials, the prior and
    sixteen warps' factor columns; plus 1 KB to align."""
    hoisted = t_in is not None
    cols = t_in if hoisted else kp * (kp + 1) // 2
    tp = -(-cols // 64)
    groups = -(-tp // MMA_SWEEP_UNITS) + 1
    per = MMA_SWEEP_UNITS
    tiles = min(per, tp)
    code_stage = max(MMA_SWEEP_ITEMS * (MMA_CHUNK * code_bytes + 16),   # rows
                     MMA_CHUNK * (MMA_SWEEP_ITEMS * code_bytes + 16))   # cols
    stage = (code_stage + (tiles + 1) * 64 * MMA_CHUNK * 2
             + -(-kp * (MMA_CHUNK + 8) * 2 // 1024) * 1024)
    end = (MMA_SWEEP_STAGES[code_bytes - 1] * stage
           + 4 * (-(-t_in // 4) * 4 if hoisted else 64 * tiles))
    part = kp * (kp + 1) // 2 + kp
    solve = 4 * (MMA_SWEEP_WARPS * part + -(-kp * (kp + 1) // 4) * 4
                 + MMA_SWEEP_WARPS * _lcol_floats(kp))
    smem = 1024 + max(end, solve)
    item_blocks = items // MMA_SWEEP_ITEMS
    chunks = frozen // MMA_CHUNK
    cap = max(1, min(chunks, SCRATCH_LIMIT_BYTES // (4 * items * part),
                     sms // groups))

    block_chunk = MMA_SWEEP_CHUNK_US + tiles * MMA_SWEEP_TILE_US

    def cost(s):  # waves of blocks (one an SM) x a block's time
        per_seg = -(-chunks // s)
        waves = -(-item_blocks * groups * -(-chunks // per_seg) // sms)
        return waves * (per_seg * block_chunk + MMA_SWEEP_BLOCK_US)

    best = min(range(1, cap + 1), key=cost)
    per_seg = -(-chunks // best)
    s = -(-chunks // per_seg)
    return SweepMmaPlan(item_blocks, groups, per, s, per_seg, (s, items, part),
                        2 + 2 * item_blocks, smem, MMA_SWEEP_LAUNCH_US + cost(best))


def walk_work(codes: torch.Tensor, orientation: str, k: int,
              max_degree: Optional[int] = None, sms: int = 132) -> int:
    """The rated entries the walk (the megakernel a warp an item, blocks of
    :data:`ITEMS_PER_BLOCK`) spends its time on in one half-sweep of
    ``codes`` in ``orientation`` at K ``k``: for each block and each
    segment of :func:`sweep_plan`, the block's items times its most-rated
    item's ratings in the segment, since a block holds its SM's slot until
    its slowest warp ends.  Equal to the rated entries when every item of
    a block has the same ratings, up to ``codes.numel()``; on skewed data
    (ml-1m, chembl) 2.5-5x them.  Sums on the codes' device."""
    c = codes if orientation == "rows" else codes.t()
    items, frozen = c.shape
    seg = sweep_plan(items, frozen, k, max_degree, sms).tiles_per_segment * BLOCK_MULTIPLE
    rows = 128 * ITEMS_PER_BLOCK   # items a step, to bound the temporaries
    total = 0
    for s0 in range(0, frozen, seg):
        for r0 in range(0, items, rows):
            n = (c[r0:r0 + rows, s0:s0 + seg] != 0).sum(1, dtype=torch.int32)
            total += int(n.view(-1, ITEMS_PER_BLOCK).amax(1).sum())
    return total * ITEMS_PER_BLOCK


def sweep_walk_us(items: int, frozen: int, work: int, kp: int, operand: str,
                  t_in: Optional[int] = None) -> float:
    """The walk's time on bf16 operands by its cost model (microseconds):
    a launch, ``items`` solves, a scan of ``items`` x ``frozen`` codes and
    ``work`` entries of :func:`walk_work` at capacity ``kp`` (8, 16, 24,
    32) with ``operand`` (#2 on an operand of ``t_in`` rows: slower when
    the bf16 rows of p pass :data:`HOISTED_L2_BYTES`)."""
    miss = t_in is not None and 2 * t_in * frozen > HOISTED_L2_BYTES
    return (WALK_LAUNCH_US + WALK_ITEM_US * items + WALK_ENTRY_US * items * frozen
            + WALK_RATING_US[operand][kp] * work * (1 + WALK_P_MISS * miss))


@functools.cache
def sweep_bf16_kernel(items: int, frozen: int, work: Optional[int], k: int,
                      operand: str = "inkernel", t_in: Optional[int] = None,
                      code_bytes: int = 1, sms: int = 132) -> str:
    """Which megakernel runs a half-sweep on bf16 operands: 'mma' (the
    tensor-core kernel, dense over the code array) or 'walk' (the rated
    entries a warp at a time, ``csrc/dense8_sweep_solve_bf16.cu``), for
    ``items`` x ``frozen`` codes whose :func:`walk_work` is ``work``, K
    ``k``, ``operand`` 'inkernel' (#1), 'tight' or 'aligned' (#2 on an
    operand of ``t_in`` rows), on a card of ``sms`` SMs.  The walk with
    ``work`` unknown (None), where the tensor-core kernel cannot run (K
    past its capacities, a scratch past :data:`SCRATCH_LIMIT_BYTES`,
    shared memory past a block's), and where its cost model's time
    (:func:`sweep_walk_us`) is below the tensor-core kernel's
    (:func:`sweep_mma_plan`'s ``us``)."""
    if work is None or k > MMA_SWEEP_CAPACITIES[-1]:
        return "walk"
    kp = next(c for c in MMA_SWEEP_CAPACITIES if c >= k)
    plan = sweep_mma_plan(items, frozen, kp, t_in, sms, code_bytes=code_bytes)
    if (4 * math.prod(plan.scratch_shape) > SCRATCH_LIMIT_BYTES
            or plan.smem_bytes > MMA_SMEM_LIMIT):
        return "walk"
    walk = sweep_walk_us(items, frozen, work, kp, operand, t_in)
    return "mma" if plan.us < walk else "walk"


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_arrivals: dict = {}


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The int32 counters of the segmented kernels (the megakernels and
    the Gram kernels: arrivals; the tensor-core megakernel also its
    tickets and departures) on one stream: zeroed once, and left zero by
    every launch (the last block to use a counter resets it), so launches
    on the stream share them."""
    key = (device, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = _arrivals[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def dense8_sweep_solve(
    codes: torch.Tensor,      # [R, C] int8 or int16 rating codes
    p_t: Optional[torch.Tensor],  # [T, N] packed_tri_t of the frozen side
                                  # (in ``layout``), or None: built in-kernel
    v_t: torch.Tensor,        # [K, N] frozen items, transposed
    lam: torch.Tensor,        # [K, K] shared prior precision
    prior_rhs: torch.Tensor,  # [K, 1] shared prior rhs (lam @ mu)
    noise_t: torch.Tensor,    # [K, items] N(0, I) draws, batch-last
    cs: float,
    cb: float,
    alpha: float,
    orientation: str,         # 'rows' | 'cols'
    layout: str = "aligned",  # 'aligned' | 'tight': p_t's packed_tri_t layout
    *,
    max_degree: Optional[int] = None,  # the side's most-rated item's ratings
    walk_work: Optional[int] = None,   # the walk's work (:func:`walk_work`)
) -> torch.Tensor:
    """u_t [K, items]: the dense8 half-sweep in one kernel, with the
    signature and batch-last layout of ``bpmf_tpu.ops.dense8.
    dense8_sweep_solve``.  ``p_t=None`` forms the packed products in the
    kernel (#1, ``layout`` ignored); a given ``p_t`` is summed over each
    item's rated entries, reading only the valid rows of ``layout`` (#2).
    ``v_t`` and ``p_t`` may be bf16 (lam, prior_rhs, noise_t float32;
    rounding as the module docstring says): at K <= 32 the tensor-core
    megakernel or the walk's bf16 instances, as :func:`sweep_bf16_kernel`
    picks them from ``walk_work`` (:func:`walk_work` of ``codes`` in this
    orientation; None: the walk; ``codes.numel()``: the most it can be, the
    tensor cores wherever they fit), past it the walk.
    The JAX package's ``BPMF_D8_FOLD`` (the cb-term as K extra rows of p_t,
    which saves the TPU an MXU pass) has no counterpart at float32: the
    kernel weighs each rating by cs*code + cb on both routes, which changes
    only rounding; on bf16 operands #2 rounds the rhs weights as its
    default does (:func:`fold_weights`).

    CPU tensors take the plain version (:func:`dense8_sweep_solve_ref`);
    CUDA tensors take the CUDA kernel, which needs float32 or bf16 operands
    and the JAX package's gate (:func:`solve_fused_supported`: K <= 41, 39
    with an aligned ``p_t``).  The kernel runs K on the next capacity of
    :data:`INKERNEL_CAPACITIES` (#2 at K in :data:`HOISTED_K` on its own
    instance), the system padded block-diagonally: zero columns of the
    frozen items, the identity on the prior's extra diagonal, zero prior
    rhs and noise; the padded rows then draw exact zeros and the result is
    sliced back to K.  #2 at a K of its own reads ``p_t``'s valid rows
    through their index (:func:`_layout_rows`).  The kernel reads the
    frozen items, the operand and the noise item-major, so ``v_t``, ``p_t``
    and ``noise_t`` cost no copy when they are transposed views of
    row-major tensors at a capacity K (as :func:`packed_tri_t` gives); the
    result is the transposed view of a row-major [items, capacity] tensor.

    The kernel splits the frozen axis into the segments of
    :func:`sweep_plan`, from ``max_degree`` (the most ratings any item of
    this side has; the sampler passes it) or from the shape alone.  The
    split changes only the order of the sums, and the result is the same
    bit for bit from launch to launch."""
    items, k = _check_args(codes, v_t, lam, prior_rhs, noise_t, orientation)
    if layout not in ("aligned", "tight"):
        raise ValueError(f"layout must be 'aligned' or 'tight', got {layout!r}")
    if p_t is not None:
        want = (_sweep_rows(k, layout), v_t.shape[1])
        if tuple(p_t.shape) != want:
            raise ValueError(f"p_t has shape {tuple(p_t.shape)}, expected "
                             f"{want} ({layout} layout)")
        if p_t.device != codes.device or p_t.dtype != v_t.dtype:
            raise ValueError(f"p_t is {p_t.dtype} on {p_t.device}, v_t "
                             f"{v_t.dtype} on {codes.device}")
    if walk_work is not None and not 0 <= walk_work <= codes.numel():
        raise ValueError(f"walk_work={walk_work} is outside 0..{codes.numel()}")
    if codes.device.type == "cpu":
        return dense8_sweep_solve_ref(codes, p_t, v_t, lam, prior_rhs, noise_t,
                                      cs, cb, alpha, orientation, layout)
    if codes.device.type != "cuda":
        raise ValueError(f"dense8_sweep_solve: no kernel for device {codes.device}")
    suffix = _operand_suffix(v_t, p_t)
    if lam.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel solves in float32, got {lam.dtype}")
    gate = "tight" if p_t is None else layout
    if not solve_fused_supported(k, gate):
        raise ValueError(
            f"the CUDA kernel takes the JAX package's megakernel gate (K <= 41 "
            f"tight, 39 aligned), got K={k}"
            + ("" if p_t is None else f" with a p_t in the {layout} layout"))
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (row-major)")
    operand = "inkernel" if p_t is None else layout
    dev = codes.device
    frozen = v_t.shape[1]
    if suffix and sweep_bf16_kernel(items, frozen, walk_work, k, operand,
                                    None if p_t is None else p_t.shape[0],
                                    codes.element_size(), _sm_count(dev)) == "mma":
        return _sweep_solve_mma(codes, p_t, v_t, lam, prior_rhs, noise_t, cs, cb,
                                alpha, orientation, layout, items)
    kp, runtime = sweep_instance(k, operand)
    plan = sweep_plan(items, frozen, kp, max_degree, _sm_count(dev))
    v, lam_c, prior, noise = _item_major(v_t, lam, prior_rhs, noise_t, kp)
    p = None if p_t is None else p_t.t().contiguous()  # [N, T]
    p_rows = _entry_rows(k, layout, dev) if runtime else None
    out = torch.empty((items, kp), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = arrivals = None
    if plan.segments > 1:
        partial = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
        arrivals = _arrival_counters(dev, stream, plan.counters)
    # temporaries may be freed before the kernel runs: the caching
    # allocator reuses their memory only for later work on this stream
    r, c = codes.shape
    err = _kernel(bool(suffix))(
        codes.data_ptr(), codes.element_size(), r, c, int(orientation == "rows"),
        kp, v.data_ptr(), None if p is None else p.data_ptr(),
        None if p_rows is None else p_rows.data_ptr(),
        0 if p is None else p.shape[1], int(layout == "aligned"), k,
        lam_c.data_ptr(), prior.data_ptr(), noise.data_ptr(),
        cs, cb, alpha, plan.segments, plan.tiles_per_segment,
        None if partial is None else partial.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense8_sweep_solve kernel launch failed: cudaError {err}")
    sweep_launches[operand + suffix] += 1
    key = sweep_instance_key(k, operand, v_t.dtype)
    sweep_instance_launches[key] = sweep_instance_launches.get(key, 0) + 1
    return out[:, :k].t()


def _sweep_solve_mma(codes, p_t, v_t, lam, prior_rhs, noise_t, cs, cb, alpha,
                     orientation, layout, items):
    """dense8_sweep_solve on bf16 CUDA operands at K <= 32: the tensor-core
    kernel (``csrc/dense8_sweep_solve_mma.cu``) on :func:`sweep_mma_plan`'s
    launch, the system padded block-diagonally to the next of
    :data:`MMA_SWEEP_CAPACITIES`; counted under ``sweep_launches``' ``_bf16``
    keys and as the instance :func:`sweep_mma_key`.  Raises on what the
    kernel refuses and on a launch error."""
    k = v_t.shape[0]
    kp = next(c for c in MMA_SWEEP_CAPACITIES if c >= k)
    dev = codes.device
    frozen = v_t.shape[1]
    v = v_t.contiguous() if kp == k else F.pad(v_t, (0, 0, 0, kp - k))  # [KP, N]
    lam_c, prior, noise = _padded_system(lam, prior_rhs, noise_t, kp)
    p = p_rows = None
    if p_t is not None:
        p = p_t.t().contiguous()                                          # [N, T]
        p_rows = _entry_rows(k, layout, dev)
    plan = sweep_mma_plan(items, frozen, kp, None if p is None else p.shape[1],
                          _sm_count(dev), code_bytes=codes.element_size())
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
    counters = _arrival_counters(dev, stream, plan.counters)
    out = torch.empty((items, kp), dtype=torch.float32, device=dev)
    r, c = codes.shape
    err = _mma_sweep_kernel()(
        codes.data_ptr(), codes.element_size(), r, c, int(orientation == "rows"),
        kp, kp if p is None else k, v.data_ptr(), None if p is None else p.data_ptr(),
        None if p_rows is None else p_rows.data_ptr(), 0 if p is None else p.shape[1],
        lam_c.data_ptr(), prior.data_ptr(), noise.data_ptr(), cs, cb, alpha,
        plan.groups, plan.segments, plan.chunks_per_segment, plan.smem_bytes,
        partial.data_ptr(), counters.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense8_sweep_solve_mma kernel launch failed: cudaError {err}")
    operand = "inkernel" if p_t is None else layout
    sweep_launches[operand + "_bf16"] += 1
    key = sweep_mma_key(k, operand)
    sweep_instance_launches[key] = sweep_instance_launches.get(key, 0) + 1
    return out[:, :k].t()


@functools.cache
def sweep_mma_key(k: int, operand: str) -> str:
    """The name of the tensor-core megakernel's instance that runs K with
    ``operand`` on bf16 operands in :data:`sweep_instance_launches`:
    '<operand>_mma_c<capacity>_bf16'."""
    kp = next(c for c in MMA_SWEEP_CAPACITIES if c >= k)
    return f"{operand}_mma_c{kp}_bf16"


@functools.cache
def _mma_sweep_kernel():
    """The tensor-core megakernel's C entry point, bf16 operands (built on
    first use)."""
    from bpmf_tpu_torch.ops._build import load

    fn = load("dense8_sweep_solve_mma").bpmf_dense8_sweep_solve_mma
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, i, p, p, p, i, p, p, p, f, f, f, i, i, i, i,
                   p, p, p, p]
    return fn


@functools.cache
def sweep_instance(k: int, operand: str) -> tuple[int, bool]:
    """(capacity, runtime K) of the megakernel instance that runs K with
    ``operand`` ('inkernel': #1; 'tight', 'aligned': #2 in that layout):
    #2 at K in :data:`HOISTED_K` on its own instance, else the next
    capacity of :data:`INKERNEL_CAPACITIES`, #2 there with a runtime K."""
    if operand != "inkernel" and k in HOISTED_K:
        return k, False
    kp = next((c for c in INKERNEL_CAPACITIES if c >= k), None)
    if kp is None:
        raise ValueError(f"K={k} is past the megakernel's largest capacity "
                         f"{INKERNEL_CAPACITIES[-1]}")
    return kp, operand != "inkernel"


@functools.cache
def sweep_instance_key(k: int, operand: str, dtype=torch.float32) -> str:
    """The name of the instance that runs K with ``operand`` on operands of
    ``dtype`` (float32 or bf16) in :data:`sweep_instance_launches`:
    '<operand>_c<capacity>', or '<layout>_k<K>' for #2's instances at
    :data:`HOISTED_K`, with :data:`OPERAND_SUFFIX`'s suffix."""
    kp, runtime = sweep_instance(k, operand)
    return (f"{operand}_c{kp}" if operand == "inkernel" or runtime
            else f"{operand}_k{k}") + OPERAND_SUFFIX[dtype]


@functools.cache
def _entry_rows(k: int, layout: str, device: torch.device) -> torch.Tensor:
    """int32 [K(K+1)/2]: the row of the hoisted operand in ``layout`` that
    holds each packed entry, in the tight order (:func:`_layout_rows`), as
    #2 at a runtime K reads it."""
    return torch.as_tensor(_layout_rows(k, layout)[0], dtype=torch.int32,
                           device=device)


def _item_major(v_t, lam, prior_rhs, noise_t, kp):
    """The megakernel's operands at its capacity ``kp``: v [N, KP], lam
    [KP, KP], prior [KP], noise [items, KP], row-major.  At kp == K they are
    copied only where they are not row-major already; past K the system is
    padded block-diagonally (zero columns, the identity, zero prior rhs and
    noise)."""
    k = v_t.shape[0]
    v = v_t.t().contiguous() if kp == k else F.pad(v_t.t(), (0, kp - k)).contiguous()
    return (v, *_padded_system(lam, prior_rhs, noise_t, kp))


def _padded_system(lam, prior_rhs, noise_t, kp):
    """lam [KP, KP], prior [KP] and noise [items, KP], row-major, padded
    block-diagonally past K as :func:`_item_major` says."""
    k = lam.shape[0]
    if kp == k:
        return (lam.contiguous(), prior_rhs.reshape(k).contiguous(),
                noise_t.t().contiguous())
    pad = (0, kp - k)
    lam_p = torch.eye(kp, dtype=lam.dtype, device=lam.device)
    lam_p[:k, :k] = lam
    return lam_p, F.pad(prior_rhs.reshape(k), pad), F.pad(noise_t.t(), pad).contiguous()


@functools.cache
def _kernel(bf16: bool = False):
    """The megakernel's C entry point for float32 or bf16 operands (built
    on first use, one library each)."""
    from bpmf_tpu_torch.ops._build import load

    name = "dense8_sweep_solve" + ("_bf16" if bf16 else "")
    fn = getattr(load(name), "bpmf_" + name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, p, p, p, i, i, i, p, p, p, f, f, f, i, i,
                   p, p, p, p]
    return fn


def dense8_sweep_solve_ref(codes, p_t, v_t, lam, prior_rhs, noise_t, cs, cb,
                           alpha, orientation, layout="aligned"):
    """Plain PyTorch version of :func:`dense8_sweep_solve`: the Gram by one
    matmul, against the [K*K, N] outer products of the frozen items
    (``p_t=None``) or against the valid rows of ``p_t`` in ``layout``; then
    ``torch.linalg`` Cholesky and triangular solves.  Reads only the lower
    triangle of ``lam + alpha * G``, like the kernels.  A non-positive-
    definite system gives NaN, as the JAX kernel does.  bf16 operands round
    as :func:`dense8_gram_rhs_ref` says, and the rest is float32."""
    dtype = _compute_dtype(v_t)
    bf16 = v_t.dtype == torch.bfloat16
    k = v_t.shape[0]
    x = codes if orientation == "rows" else codes.t()    # [items, N]
    ind = (x != 0).to(dtype)
    cv = x.to(dtype)
    v = v_t.to(dtype)
    if p_t is None:
        outer = (v[:, None, :] * v[None, :, :]).reshape(k * k, -1)
        if bf16:
            outer = outer.to(torch.bfloat16).to(dtype)
        gram = (ind @ outer.t()).reshape(-1, k, k)        # [items, K, K]
    else:
        rows, ii, jj = (torch.as_tensor(a, dtype=torch.long, device=v_t.device)
                        for a in _layout_rows(k, layout))
        gram = ind.new_zeros((x.shape[0], k, k))
        gram[:, ii, jj] = ind @ p_t[rows].to(dtype).t()   # lower triangle
    if bf16 and p_t is not None:
        ws, wb = fold_weights(v_t, cs, cb)
        rhs = cv @ ws.t() + ind @ wb.t()                  # [items, K]
    else:
        rhs = cs * (cv @ v.t()) + cb * (ind @ v.t())      # [items, K]
    chol = cholesky_or_nan(lam + alpha * gram)
    y = torch.linalg.solve_triangular(
        chol, (rhs + prior_rhs.t())[..., None], upper=False)
    y = y + noise_t.t()[..., None]
    u = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return u[..., 0].t()
