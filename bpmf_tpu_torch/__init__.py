"""bpmf_tpu_torch — the BPMF Gibbs sampler of ``bpmf_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port imports ``torch`` and nothing of ``jax`` or of the JAX package: it
keeps its own copies of the host modules it needs, under the JAX package's
module names (``config``, ``io``, ``datasets``, ``sparse``,
``parallel.partition``, ``utils.counters``, the CLI parser).  Ported so
far: the one-device run in float32 or float64, any ratings and any K, on
every Gram route of one device (the int8 dense stream with its megakernel
and split pipeline, the dense and fused-dense adjacency, the degree
buckets), every solver, the propagated posterior, the output files,
checkpoints and the perf-debug surfaces; and multi-device over
``torch.distributed``, one process per rank (``--devices N``, across
processes ``--dist``): the sharded dense8 sweep in gather and reduce mode,
gather mode on the dense routes, the buckets in gather mode (all_gather or
the halo ring) and in reduce mode (plain or chunked), and the sharded
evaluation; every route also with bf16 matmul inputs
(``Config(matmul_dtype="bfloat16")``).

    from bpmf_tpu_torch import BPMF, Config, synth_movielens
    train, test = synth_movielens()          # ml-1m-sized synthetic ratings
    BPMF(Config(num_latent=32), train, test, device="cuda").run()
"""

__version__ = "0.1.0"

from bpmf_tpu_torch.config import Config  # noqa: F401
from bpmf_tpu_torch.datasets import synth_chembl, synth_jester, synth_movielens  # noqa: F401
from bpmf_tpu_torch.io import read_matrix, write_matrix  # noqa: F401


def __getattr__(name):
    # lazy, like the JAX package: the sampler pulls in scipy and the kernel modules
    if name == "BPMF":
        from bpmf_tpu_torch.sampler import BPMF

        return BPMF
    raise AttributeError(name)
