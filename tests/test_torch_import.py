"""bpmf_tpu_torch imports with jax, triton and the JAX package
unimportable (a GPU deployment of the port need not have any of them), and
a CUDA request without CUDA raises instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "triton", "bpmf_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
""")


def _run(code):
    proc = subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_imports_without_jax_or_triton():
    """Every module of the port imports, and none of jax, jaxlib, triton or
    the JAX package ends up in sys.modules."""
    assert _run("""
        import bpmf_tpu_torch
        import bpmf_tpu_torch.ops, bpmf_tpu_torch.ops.dense8
        import bpmf_tpu_torch.ops.pallas_solve
        import bpmf_tpu_torch.ops.mvnormal, bpmf_tpu_torch.ops.update
        import bpmf_tpu_torch.ops._build
        import bpmf_tpu_torch.models, bpmf_tpu_torch.models.bpmf
        import bpmf_tpu_torch.parallel, bpmf_tpu_torch.parallel.spmd
        import bpmf_tpu_torch.sampler, bpmf_tpu_torch.cli
        import bpmf_tpu_torch.convert, bpmf_tpu_torch.device
        from bpmf_tpu_torch.entry import dryrun_multichip, entry
        import bpmf_tpu_torch.bench
        from bpmf_tpu_torch.ops import launch_counts
        import bpmf_tpu_torch.config, bpmf_tpu_torch.datasets
        import bpmf_tpu_torch.io, bpmf_tpu_torch.io.matrix_io
        import bpmf_tpu_torch.io.native
        from bpmf_tpu_torch.models import (
            EvalData, EvalState, Metrics, SideData, SideState, gibbs_iter,
            half_sweep, init_side_state, predict)
        from bpmf_tpu_torch.convert import model_from_numpy
        import bpmf_tpu_torch.sparse, bpmf_tpu_torch.parallel.partition
        import bpmf_tpu_torch.utils, bpmf_tpu_torch.utils.counters
        import bpmf_tpu_torch.ops.cholsolve
        import bpmf_tpu_torch.checkpoint
        import bpmf_tpu_torch.scripts, bpmf_tpu_torch.scripts.gather_probe
        bpmf_tpu_torch.BPMF
        bpmf_tpu_torch.write_matrix, bpmf_tpu_torch.synth_chembl
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton", "bpmf_tpu")]
        assert not bad, bad
        assert "bench" not in sys.modules   # the JAX package's bench.py
        print("ok")
    """) == "ok"


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour of a host without CUDA")
def test_cuda_request_without_cuda_raises():
    """The default device is CUDA; without it the sampler fails loudly and
    nothing runs on the CPU instead."""
    assert _run("""
        import scipy.sparse as sp
        from bpmf_tpu_torch import Config
        from bpmf_tpu_torch.sampler import BPMF

        m = sp.csc_matrix(([2.0, 3.0, 5.0], ([0, 1, 2], [0, 1, 0])), shape=(3, 2))
        try:
            BPMF(Config(nsims=2), m, m)
        except RuntimeError as e:
            assert "cuda" in str(e), e
            print("raised")
    """) == "raised"
