"""The traced window's reduction and the readers, on a hand-made Chrome
trace: busy time as the union of device intervals, each kernel charged to
the span that launched it, idle gaps named by the host's span."""

from __future__ import annotations

from benchmark import readers, trace


def _events():
    x = "X"
    return [
        {"ph": x, "cat": "user_annotation", "name": "bench.window", "ts": 0,
         "dur": 100},
        {"ph": x, "cat": "user_annotation", "name": "bench.fwd", "ts": 0,
         "dur": 10},
        {"ph": x, "cat": "user_annotation", "name": "bench.bwd", "ts": 10,
         "dur": 30},
        {"ph": x, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1, "args": {"correlation": 1}},
        {"ph": x, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "args": {"correlation": 2}},
        {"ph": x, "cat": "kernel", "ts": 5, "dur": 20,
         "name": "void (anonymous namespace)::tracer_forward_kernel<true>"
                 "(int const*, float*)", "args": {"correlation": 1}},
        {"ph": x, "cat": "kernel", "ts": 15, "dur": 20,
         "name": "void at::native::index_backward(long const*)",
         "args": {"correlation": 2}},
        {"ph": x, "cat": "gpu_user_annotation", "name": "bench.fwd",
         "ts": 5, "dur": 50},
    ]


def test_reduce_events():
    r = trace.reduce_events(_events())
    assert abs(r.window_s - 100e-6) < 1e-12
    assert abs(r.busy_s - 30e-6) < 1e-12          # [5, 35] united
    assert abs(r.span_device_s["bench.fwd"] - 20e-6) < 1e-12
    assert abs(r.span_device_s["bench.bwd"] - 20e-6) < 1e-12
    assert r.gaps[0][1] > r.gaps[-1][1]
    b = trace.breakdown(r)
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) <= 10


def test_readers():
    r = trace.reduce_events(_events())
    ctx = {"reading": r, "steps": 2, "graph_ms": 1.0, "eager_ms": 4.0,
           "tracer_least_s": 10e-6, "ops_s": 1e-3, "kernel_prefix": "tracer_"}
    assert abs(readers.span_ms(ctx, "bench.fwd") - 0.01) < 1e-12
    assert readers.span_ms(ctx, "bench.bin") is None
    assert readers.host_share(ctx) == 75.0
    assert abs(readers.roofline(ctx) - 50.0) < 1e-9
    assert abs(readers.mfu(ctx) - 25.0) < 1e-9
    assert abs(readers.idle(ctx) - 70.0) < 1e-9
    assert readers.roofline({**ctx, "kernel_prefix": "none_"}) is None
