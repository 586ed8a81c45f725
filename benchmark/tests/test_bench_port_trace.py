"""The program's spans in a traced window (`port_trace.py`), on a
hand-made Chrome trace that holds the harness's spans and the program's
`lrt.*` spans: the harness's reading is unmoved by them; each kernel, sync
and idle gap is charged to the innermost open port span; the longest gaps
are named by a port span first; the readers tell a traced zero from a
trace with no port span."""

from __future__ import annotations

import json

import pytest

from benchmark import port_trace, trace

X = "X"


def _ann(name, ts, dur):
    return {"ph": X, "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": X, "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": X, "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


HARNESS = [
    _ann("bench.window", 0, 100),
    _ann("bench.fwd", 0, 10),
    _ann("bench.bwd", 10, 30),
    _launch(2, 1), _launch(13, 2), _launch(46, 3),
    _kernel("void tracer_forward_kernel<true>(int const*)", 5, 20, 1),
    _kernel("void at::native::index_backward(long const*)", 15, 20, 2),
    _kernel("void at::native::multi_tensor_apply_kernel(float*)", 50, 12,
            3),
    _launch(20, 4, "cudaStreamSynchronize"),
    _launch(90, 5, "cudaDeviceSynchronize"),
]
# lrt.step [0, 60] holds render [1, 9] (kernel 1), chamfer [12, 40]
# (kernel 2, a sync at 20) and adam [45, 50] (kernel 3).
PORT = [
    _ann("lrt.step", 0, 60),
    _ann("lrt.render", 1, 8),
    _ann("lrt.chamfer", 12, 28),
    _ann("lrt.adam", 45, 5),
    {"ph": X, "cat": "gpu_user_annotation", "name": "lrt.chamfer",
     "ts": 15, "dur": 20},
]


def _close(a, b):
    return abs(a - b) < 1e-12


def test_harness_reading_is_unmoved_by_port_spans():
    assert trace.reduce_events(HARNESS + PORT) == trace.reduce_events(
        HARNESS)


def test_device_syncs_and_idle_go_to_the_innermost_port_span():
    p = port_trace.reduce_port_events(HARNESS + PORT)
    assert _close(p.device_s["lrt.render"], 20e-6)
    assert _close(p.device_s["lrt.chamfer"], 20e-6)
    assert _close(p.device_s["lrt.adam"], 12e-6)
    assert "lrt.step" not in p.device_s
    assert _close(p.root_device_s["lrt.step"], 52e-6)
    assert p.syncs == {"lrt.chamfer": 1, port_trace.OUTSIDE: 1}
    # Gaps [0, 5] in the step, [35, 50] in Chamfer, [62, 100] outside.
    assert _close(p.idle_s["lrt.step"], 5e-6)
    assert _close(p.idle_s["lrt.chamfer"], 15e-6)
    assert _close(p.idle_s[port_trace.OUTSIDE], 38e-6)
    assert _close(p.root_idle_s["lrt.step"], 20e-6)
    assert _close(p.host_s["lrt.step"], 19e-6)
    assert _close(p.host_s["lrt.chamfer"], 28e-6)


def test_gaps_are_named_by_a_port_span_first():
    p = port_trace.reduce_port_events(HARNESS + PORT)
    assert [n for n, _ in p.gaps] == [port_trace.OUTSIDE, "lrt.chamfer",
                                      "lrt.step"]
    harness = trace.reduce_events(HARNESS + PORT)
    # The harness names the gap at 35 by its own span.
    assert [n for n, _ in harness.gaps][1] == "bench.bwd"


def test_readers_tell_a_traced_zero_from_no_port_span():
    ctx = {"port": port_trace.reduce_port_events(HARNESS + PORT),
           "steps": 2}
    assert _close(port_trace.port_span_ms(ctx, "lrt.render"), 0.01)
    assert _close(port_trace.port_span_ms(ctx, "lrt.render",
                                          "lrt.chamfer"), 0.02)
    assert port_trace.port_span_ms(ctx, "lrt.bin") == 0.0
    assert port_trace.port_syncs(ctx) == 0.5
    assert _close(port_trace.port_idle_ms(ctx, "lrt.chamfer"), 0.0075)
    assert port_trace.port_idle_ms(ctx, "lrt.bin") == 0.0
    none = {"port": port_trace.reduce_port_events(HARNESS), "steps": 2}
    for c in (none, {"steps": 2}):
        assert port_trace.port_span_ms(c, "lrt.render") is None
        assert port_trace.port_syncs(c) is None
        assert port_trace.port_idle_ms(c, "lrt.chamfer") is None


@pytest.mark.parametrize("wrap", [list, lambda e: {"traceEvents": e}])
def test_keeping_port_reads_the_harness_trace(tmp_path, wrap):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(wrap(HARNESS + PORT)))
    original = trace.reduce_events
    with port_trace.keeping_port() as kept:
        r = trace.read_chrome(str(path))
    assert trace.reduce_events is original
    assert r == trace.reduce_events(HARNESS)
    assert kept["port"] == port_trace.reduce_port_events(HARNESS + PORT)
