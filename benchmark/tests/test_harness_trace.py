"""The trace reduction on a hand-made chrome trace: attribution of device
operations to spans through their launches, the kernel-name fallback, the
union of busy intervals over two streams, and the idle gaps by span."""

from __future__ import annotations

import pytest

from benchmark import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _events():
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _x("user_annotation", "iter_fn", 0, 60),
        _x("user_annotation", "half_sweep", 5, 30),
        _x("user_annotation", "predict", 40, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=3),
        # #1 on two streams, overlapping: busy counts the union once
        _x("kernel", "sweep_solve_kernel<32>", 10, 20, tid=7, correlation=1),
        _x("kernel", "sweep_solve_kernel<32>", 20, 20, tid=8, correlation=2),
        _x("kernel", "gather", 45, 5, tid=7, correlation=3),
        # launched where the trace has no launch: the layer patterns decide
        _x("kernel", "chol_solve_sample_kernel", 70, 10, tid=7, correlation=99),
        _x("gpu_memcpy", "Memcpy DtoH", 95, 10, tid=7, correlation=98),
        # outside the window: ignored
        _x("kernel", "late", 200, 10, tid=7, correlation=97),
    ]


def test_summary():
    s = trace.summarize(_events(), {"iter_fn", "half_sweep", "predict"},
                        {"half-sweep": ["chol_solve"], "evaluation": []})
    assert s.window_s == pytest.approx(100e-6)
    # busy: [10, 40] + [45, 50] + [70, 80] + [95, 100] (cut at the window)
    assert s.busy_s == pytest.approx(50e-6)
    assert s.span_device_s["half_sweep"] == pytest.approx(40e-6)
    assert s.span_device_s["predict"] == pytest.approx(5e-6)
    assert s.pattern_device_s == {"half-sweep": pytest.approx(10e-6)}
    assert s.unattributed_s == pytest.approx(5e-6)
    assert s.n_device_ops == 5
    assert s.device_ops[0] == ["sweep_solve_kernel<32>", pytest.approx(40e-6)]
    gaps = dict(s.idle_gaps)
    # each gap is named by the innermost span open where it begins:
    # [0, 10) and [50, 70) iter_fn, [40, 45) predict, [80, 95) none
    assert gaps == {"iter_fn": pytest.approx(30e-6),
                    "predict": pytest.approx(5e-6),
                    trace.OUTSIDE: pytest.approx(15e-6)}


def test_nested_spans_opening_together():
    p = trace._Painter([(0, 10, "outer"), (0, 5, "inner")])
    assert p.at(1) == "inner"
    assert p.at(6) == "outer"
    assert p.at(11) is None


def test_no_window_span_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize([_x("kernel", "k", 0, 1)], set(), {})
