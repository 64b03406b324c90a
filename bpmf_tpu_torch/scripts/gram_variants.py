"""Where the in-kernel Gram's (#3) time goes on the card: the kernel as
built, and variants of its float32 library (``csrc/dense8_gram_rhs.cu``
on the template ``csrc/dense8_gram_rhs.cuh``) with one part taken out,
each timed on the same inputs.

    python -m bpmf_tpu_torch.scripts.gram_variants [--variants a,b,...]

Variants (each a textual edit of a copy of the template, built with the
package's nvcc flags into ``build/gram_variants/<name>/``; a variant whose
edit no longer matches the source stops the script):

* ``nofma``: no Gram FMAs (the rhs, the scan, the staging and the row
  copies stay);
* ``noring``: no copies of the rated rows of v (the FMAs run on whatever
  the ring holds);
* ``noepi``: no writes of the Gram (the sums stay live);
* ``tiles``: every K on the 4x4-tile instance that serves K 65-79.

Inputs: random codes 1..5 at ~4% in [6144, 4096] (the padded ml-1m shape)
at K=64 and K=32, rows and cols, and the chembl synth's code array at
K=64 (the proteins, cols, with their most-rated item's degree), random v.
Prints one JSON line per variant: the median CUDA-event time of each
input, ms.  The variants compute wrong Grams; only their times mean
anything.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess

EDITS = {
    "nofma": [("for (int j4 = 0; j4 < KP / 4; ++j4) {\n      const auto c = load_piece(",
               "for (int j4 = 0; j4 < 0; ++j4) {\n      const auto c = load_piece(")],
    "noring": [("        cp_async<16>(dst + s * kv + 4 * piece,",
                "        if (kv < 0) cp_async<16>(dst + s * kv + 4 * piece,")],
    "noepi": [("if (j <= i) dst[tight_row(i, j, k)] = acc.g[q][j];",
               "if (j <= i && acc.g[q][j] == 1234.5f) dst[tight_row(i, j, k)] = acc.g[q][j];")],
    "tiles": [("  if (a.k <= 16) return launch_rows<T, 16>(grid, s, a);\n"
               "  if (a.k <= 32) return launch_rows<T, 32>(grid, s, a);\n"
               "  if (a.k <= 48) return launch_rows<T, 48>(grid, s, a);\n"
               "  if (a.k <= 64) return launch_rows<T, 64>(grid, s, a);\n", "")],
}


def build_variant(name: str) -> str:
    """The variant's shared library, built from an edited copy."""
    from bpmf_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "gram_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in ("dense8_gram_rhs.cu", "dense8_gram_rhs.cuh", "dense8_stage.cuh"):
        shutil.copy(_build.CSRC / f, out / f)
    src = (out / "dense8_gram_rhs.cuh").read_text()
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"gram_variants: the {name} edit no longer matches "
                             "csrc/dense8_gram_rhs.cuh")
        src = src.replace(old, new)
    (out / "dense8_gram_rhs.cuh").write_text(src)
    lib = out / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "dense8_gram_rhs.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"gram_variants: nvcc failed on {name}:\n{proc.stderr}")
    return str(lib)


def inputs():
    """(name, codes, orientation, v_t, max_degree) on the card."""
    import torch

    from bpmf_tpu_torch import Config, synth_chembl
    from bpmf_tpu_torch.sampler import BPMF

    g = torch.Generator(device="cuda").manual_seed(1)
    shape = (6144, 4096)
    codes = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.04,
                        torch.randint(1, 6, shape, generator=g, device="cuda"),
                        0).to(torch.int8)
    out = []
    for k in (64, 32):
        for orientation in ("rows", "cols"):
            frozen = shape[1] if orientation == "rows" else shape[0]
            out.append((f"random_k{k}_{orientation}", codes, orientation,
                        0.5 * torch.randn((k, frozen), generator=g, device="cuda"),
                        None))
    train, test = synth_chembl()
    s = BPMF(Config(num_latent=64), train, test, out=open(os.devnull, "w"),
             device="cuda")
    s.setup()
    out.append(("chembl_proteins_k64", s._codes, "cols",
                0.5 * torch.randn((64, s._codes.shape[0]), generator=g, device="cuda"),
                int(s.movies.max_degree)))
    return out


def times(cases, reps=15):
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    res = {}
    for name, codes, orientation, v_t, deg in cases:
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        for _ in range(3):
            fn(codes, None, v_t, 2.0, -7.2, max_degree=deg)
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(codes, None, v_t, 2.0, -7.2, max_degree=deg)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        res[name] = sorted(ms)[reps // 2]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="nofma,noring,noepi,tiles")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gram_variants: needs an NVIDIA GPU")
    from bpmf_tpu_torch.device import card_power
    from bpmf_tpu_torch.ops import dense8 as d8

    names = [n for n in a.variants.split(",") if n]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))
    cases = inputs()
    smi = card_power()
    print(json.dumps({"variant": "as built", **times(cases), "nvidia_smi": smi}),
          flush=True)
    real = d8._gram_kernel
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).bpmf_dense8_gram_rhs
        fn.restype, fn.argtypes = real().restype, real().argtypes
        d8._gram_kernel = lambda bf16=False, fn=fn: fn
        try:
            print(json.dumps({"variant": name, **times(cases)}), flush=True)
        finally:
            d8._gram_kernel = real


if __name__ == "__main__":
    main()
