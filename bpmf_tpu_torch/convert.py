"""Sampler state carried between the JAX package and the port.

The exchange format is a dict of numpy arrays under the key names of
``bpmf_tpu/checkpoint.py`` (``movies.items``, ``movies.hp.mu``,
``users.cov``, ..., ``eval.pavg``, ``eval.pm2``): items and aggregates in
ORIGINAL item order, ``aggr_prod`` as the full [num, K, K].  Either package
can then compute from the same state, at any device count: with ``rank``,
:func:`state_from_numpy` gives one rank its shard of the padded layout.
The functional model's NamedTuples (``SideState``, ``SideData``,
``EvalData``, ``EvalState``) cross as numpy arrays in padded order,
:func:`model_from_numpy`.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from bpmf_tpu_torch.models.bpmf import (
    EvalData,
    EvalState,
    SideData,
    SideState,
    aggr_prod_full,
    aggr_prod_pack,
)
from bpmf_tpu_torch.ops.mvnormal import HyperParams
from bpmf_tpu_torch.ops.update import BucketDev
from bpmf_tpu_torch.parallel.partition import SideMaps

__all__ = ["model_from_numpy", "state_from_numpy", "state_to_numpy"]


def model_from_numpy(x, device, dtype, splits=()):
    """The port's ``SideState``, ``SideData``, ``EvalData`` or ``EvalState``
    from the JAX package's NamedTuple of the same name with numpy arrays in
    padded order (``jax.device_get`` of it): the same fields on ``device``,
    floats in ``dtype``, indices as int64.  A ``SideData`` needs its
    buckets' ``splits``."""
    kind = type(x).__name__

    def dev(arr):
        if arr is None:
            return None
        arr = np.array(arr)
        dt = torch.long if np.issubdtype(arr.dtype, np.integer) else dtype
        return torch.as_tensor(arr, dtype=dt, device=device)

    def tensors(nt):
        return {n: dev(a) for n, a in nt._asdict().items()}

    if kind == "SideState":
        fields = tensors(x._replace(hp=None))
        return SideState(**{**fields, "hp": HyperParams(**tensors(x.hp))})
    if kind == "SideData":
        buckets = tuple(
            BucketDev.from_bucket(
                types.SimpleNamespace(**b._asdict(), split=split), dtype, device)
            for b, split in zip(x.buckets, splits, strict=True))
        return SideData(buckets=buckets, prop_mu=dev(x.prop_mu),
                        prop_lambda=dev(x.prop_lambda))
    if kind == "EvalData":
        return EvalData(**tensors(x))
    if kind == "EvalState":
        return EvalState(**tensors(x))
    raise TypeError(f"no port counterpart for {kind}")


def _side_from_numpy(payload: dict, prefix: str, maps: SideMaps, device,
                     dtype, rank: int) -> SideState:
    idx = maps.orig_to_padded
    mine = slice(rank * maps.local_pad, (rank + 1) * maps.local_pad)

    def padded(arr):
        out = np.zeros((maps.padded_num,) + arr.shape[1:], arr.dtype)
        out[idx] = arr
        return out[mine]

    def dev(arr):
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)

    aggr_mu = aggr_prod = None
    if f"{prefix}.aggr_mu" in payload:
        aggr_mu = dev(padded(payload[f"{prefix}.aggr_mu"]))
        aggr_prod = dev(aggr_prod_pack(padded(payload[f"{prefix}.aggr_prod"])))
    return SideState(
        items=dev(padded(payload[f"{prefix}.items"])),
        hp=HyperParams(mu=dev(payload[f"{prefix}.hp.mu"]),
                       lambda_f=dev(payload[f"{prefix}.hp.lambda_f"]),
                       lambda_l=dev(payload[f"{prefix}.hp.lambda_l"])),
        sum=dev(payload[f"{prefix}.sum"]),
        cov=dev(payload[f"{prefix}.cov"]),
        norm=dev(payload[f"{prefix}.norm"]),
        aggr_mu=aggr_mu,
        aggr_prod=aggr_prod,
    )


def state_from_numpy(payload: dict, maps_m: SideMaps, maps_u: SideMaps,
                     device, dtype, rank: int = 0
                     ) -> tuple[SideState, SideState, EvalState]:
    """(movies state, users state, eval state) on ``device`` from a
    checkpoint-format dict; ``maps_*`` give each side's padded order over
    ``maps_*.n_devices`` ranks, and ``rank`` which rank's shard to keep: its
    rows of each side's padded layout, and its 1/D of the test entries'
    Welford state, padded to a multiple of D as the sampler shards the test
    entries (all of both on one device)."""
    state_m = _side_from_numpy(payload, "movies", maps_m, device, dtype, rank)
    state_u = _side_from_numpy(payload, "users", maps_u, device, dtype, rank)
    d = maps_u.n_devices

    def entries(arr):
        if d == 1:
            return torch.as_tensor(arr, dtype=dtype, device=device)
        per = -(-len(arr) // d)
        arr = np.pad(arr, (0, per * d - len(arr)))[rank * per:(rank + 1) * per]
        return torch.as_tensor(arr, dtype=dtype, device=device)

    est = EvalState(pavg=entries(payload["eval.pavg"]),
                    pm2=entries(payload["eval.pm2"]))
    return state_m, state_u, est


def state_to_numpy(state_m: SideState, state_u: SideState, est: EvalState,
                   maps_m: SideMaps, maps_u: SideMaps) -> dict:
    """Inverse of :func:`state_from_numpy`: float64 numpy arrays under the
    checkpoint key names, in original item order."""

    def host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    out = {"eval.pavg": host(est.pavg), "eval.pm2": host(est.pm2)}
    for prefix, state, maps in (("movies", state_m, maps_m),
                                ("users", state_u, maps_u)):
        idx = maps.orig_to_padded
        out[f"{prefix}.items"] = host(state.items)[idx]
        out[f"{prefix}.hp.mu"] = host(state.hp.mu)
        out[f"{prefix}.hp.lambda_f"] = host(state.hp.lambda_f)
        out[f"{prefix}.hp.lambda_l"] = host(state.hp.lambda_l)
        out[f"{prefix}.sum"] = host(state.sum)
        out[f"{prefix}.cov"] = host(state.cov)
        out[f"{prefix}.norm"] = host(state.norm)
        if state.aggr_mu is not None:
            out[f"{prefix}.aggr_mu"] = host(state.aggr_mu)[idx]
            out[f"{prefix}.aggr_prod"] = aggr_prod_full(
                host(state.aggr_prod)[idx], state.aggr_mu.shape[-1])
    return out
