"""Multi-device chains, continued (tests/test_torch_multi.py holds the
helpers): dense8 with a propagated posterior on the users (the sharded
sweep's per-item prior, #6) and the degree buckets in gather mode, the
port at 2 and 4 gloo ranks against the JAX package at n_devices 2 and 4
within 2e-5, and the port's chains at 1, 2 and 4 ranks."""

import pytest
import torch

from bpmf_tpu.ops import pallas_solve as jax_ps
from tests.test_torch_multi import (
    build_cases,
    check_port_matches_jax,
    check_rank_count_invariance,
    port_results,
)

torch.set_num_threads(1)

CASES = ("dense8_prop", "bucketed")


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return build_cases(CASES, tmp_path_factory)


@pytest.fixture(scope="module")
def port(cases):
    return port_results(cases)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_port_matches_jax(cases, port, name, d):
    """The port at d gloo ranks against the JAX package at n_devices d:
    per-iteration rmse, rmse_avg and norms, and both factor tables, within
    2e-5; both take the same routes (dense8 with the per-item prior takes
    the sharded split pipeline, #3 + #6)."""
    check_port_matches_jax(cases, port, name, d)


@pytest.mark.parametrize("name", CASES)
def test_rank_count_invariance(port, name):
    """The same chain at 1, 2 and 4 ranks, within 2e-5."""
    check_rank_count_invariance(port, name)
