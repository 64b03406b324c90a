"""Mid-run checkpoint / resume (port of ``bpmf_tpu/checkpoint.py``).

The full sampler state (items, hyperparameters, stats, aggregates, the
Welford predictions, the iteration counter and the random key) round-trips
through one ``.npz`` file in the JAX package's format: the same keys and
``FORMAT_VERSION``, state in ORIGINAL item order (``convert.py``), the
aggregated products as full [num, K, K].  So a checkpoint of either
package loads in the other.

The key: the JAX package stores its raw threefry key, which for
``jax.random.PRNGKey(seed)`` is the uint32 pair ``[seed >> 32, seed &
0xffffffff]``.  The port's draws are keyed by (seed, iteration, side), so it
writes the same pair and reads the seed back from it; resuming needs
nothing else.  After a load across packages each continues with its own
random stream: only the state is carried over.

Across rank counts: a run of D ranks gathers its shards into that one
file, which rank 0 writes; a run of any rank count resumes from it, each
rank taking its shard of its own padded layout.
"""

from __future__ import annotations

import zlib

import numpy as np

from bpmf_tpu_torch.convert import state_from_numpy, state_to_numpy
from bpmf_tpu_torch.utils.counters import count_sync

__all__ = ["FORMAT_VERSION", "dataset_hash", "seed_key", "seed_from_key",
           "save", "load"]

FORMAT_VERSION = 1


def dataset_hash(sampler) -> np.uint64:
    """Content hash of (train, test), crc32 over their CSC arrays and
    shapes: binds a checkpoint to its dataset, so a resume against other
    data fails loudly (``checkpoint.dataset_hash``)."""
    h = 0
    for m in (sampler.train, sampler.test):
        for arr in (m.indptr, m.indices, m.data):
            h = zlib.crc32(np.ascontiguousarray(arr).tobytes(), h)
        h = zlib.crc32(np.asarray(m.shape, np.int64).tobytes(), h)
    return np.uint64(h)


def seed_key(seed: int) -> np.ndarray:
    """The raw key ``jax.random.PRNGKey(seed)`` holds, uint32 [2]."""
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def seed_from_key(key) -> int:
    """Inverse of :func:`seed_key`."""
    hi, lo = (int(x) for x in np.asarray(key, np.uint64).reshape(2))
    return (hi << 32) | lo


def save(path: str, sampler) -> None:
    """Write the sampler's full state to ``path`` (.npz; numpy appends the
    suffix when it is missing).  At D > 1 every rank takes part in the
    gather of the shards and rank 0 writes (a host sync, site
    ``checkpoint``)."""
    state_m, state_u, est = sampler.state_host()
    if sampler.rank != 0:
        return
    count_sync("checkpoint")
    payload = {
        "format_version": FORMAT_VERSION,
        "iter": sampler.iter,
        "key": seed_key(sampler.seed),
        "num_latent": sampler.cfg.num_latent,
        "nsims": sampler.cfg.nsims,
        "burnin": sampler.cfg.burnin,
        "dataset_hash": dataset_hash(sampler),
        "rmse": sampler.rmse,
        "rmse_avg": sampler.rmse_avg,
    }
    payload.update(state_to_numpy(state_m, state_u, est, sampler.movies.maps,
                                  sampler.users.maps))
    np.savez_compressed(path, **payload)


def load(path: str, sampler) -> None:
    """Restore state saved by :func:`save` (or by the JAX package) into the
    sampler, which must run the same dataset at the same K.  The
    aggregates are kept only when the sampler writes outputs
    (``output_dir``), and start at zero when the file has none."""
    data = dict(np.load(path))
    version = int(data["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    cfg = sampler.cfg
    if int(data["num_latent"]) != cfg.num_latent:
        raise ValueError(f"checkpoint K={int(data['num_latent'])} != config "
                         f"K={cfg.num_latent}")
    if "dataset_hash" in data:
        want, have = np.uint64(data["dataset_hash"]), dataset_hash(sampler)
        if want != have:
            raise ValueError(
                f"checkpoint was written for a different dataset "
                f"(hash {want:#x} != {have:#x}); refusing to resume")
    sampler.setup()
    aggregate = bool(cfg.output_dir)
    if not aggregate:
        data = {n: v for n, v in data.items() if ".aggr_" not in n}
    state_m, state_u, est = state_from_numpy(
        data, sampler.movies.maps, sampler.users.maps, sampler.device,
        sampler.dtype, rank=sampler.rank)
    if aggregate and state_m.aggr_mu is None:
        k = cfg.num_latent

        def zeros(state):
            pn = state.items.shape[0]
            return state._replace(
                aggr_mu=state.items.new_zeros((pn, k)),
                aggr_prod=state.items.new_zeros((pn, k * (k + 1) // 2)))
        state_m, state_u = zeros(state_m), zeros(state_u)
    sampler.state_m, sampler.state_u, sampler.est = state_m, state_u, est
    sampler.iter = int(data["iter"])
    sampler.set_seed(seed_from_key(data["key"]))
    sampler.rmse = float(data["rmse"])
    sampler.rmse_avg = float(data["rmse_avg"])
