"""The arithmetic the per-layer metric readers under `metrics/` share.

A reader takes the traced run's context: `reading` (`trace.Reading`),
`steps` (the traced steps), and what the traffic's `after_trace` adds
(`graph_ms` and `eager_ms` a step, `tracer_least_s` over all the traced
steps, `ops_s` a step, `kernel_prefix`).
A reader that finds nothing to read returns None, and the run leaves its
metric out of the result.
"""

from __future__ import annotations

import re


def is_kernel(op: str, prefix: str) -> bool:
    """Whether a device op is a kernel whose function name starts with
    `prefix`: `void (anonymous namespace)::tracer_forward_kernel<true>(int
    const*, ...)` is a `tracer_` kernel."""
    return re.search(r"(^|[\s:])" + re.escape(prefix), op) is not None


def span_ms(ctx: dict, span: str) -> float | None:
    """Device ms per step charged to a harness span."""
    s = ctx["reading"].span_device_s.get(span)
    return None if not s else s / ctx["steps"] * 1e3


def host_share(ctx: dict) -> float | None:
    """1 - graph ms / eager ms of the same steps, in %."""
    g, e = ctx.get("graph_ms"), ctx.get("eager_ms")
    return None if not g or not e else 100.0 * (1.0 - g / e)


def roofline(ctx: dict) -> float | None:
    """The kernels' least time over their measured time, in %."""
    prefix = ctx.get("kernel_prefix")
    least = ctx.get("tracer_least_s")
    if not prefix or not least:
        return None
    t = sum(s for name, s in ctx["reading"].op_s.items()
            if is_kernel(name, prefix))
    return None if t <= 0.0 else 100.0 * least / t


def mfu(ctx: dict) -> float | None:
    """The step's operations at the peak rates over its eager time, %."""
    ops, e = ctx.get("ops_s"), ctx.get("eager_ms")
    return None if not ops or not e else 100.0 * ops / (e * 1e-3)


def idle(ctx: dict) -> float | None:
    """The traced window's share with no device operation running, %."""
    r = ctx["reading"]
    return None if r.window_s <= 0.0 else 100.0 * (1.0 - r.busy_s
                                                    / r.window_s)
