"""The model: per-side state, half-sweep, prediction, full Gibbs iteration
(the names of ``bpmf_tpu.models``)."""

from bpmf_tpu_torch.models.bpmf import (  # noqa: F401
    EvalData,
    EvalState,
    Metrics,
    SideData,
    SideState,
    gibbs_iter,
    half_sweep,
    init_side_state,
    predict,
)
