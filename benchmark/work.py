"""The work a step needs, counted from what no implementation choice can
move, and the card's published peaks.

Operations per composited hit and per (ray, candidate) intersection are
the counts `chip_smoke.py` states, with their basis:

  * PAIR_FLOPS: one ray-surfel intersection and its gates (three 3-dots,
    the range, splat coordinates, exp, opacity, clamps);
  * FWD_HIT_FLOPS: a composited hit in the forward (48 SH multiply-adds
    and the channel sums);
  * BWD_HIT_FLOPS: a hit in the backward (dL/dw, dL/dalpha, the chain to
    the candidate's fields and its 63 sums), of which BWD_SH_FLOPS (the
    48 d_sh multiply-adds) may run as one TF32 product each.

They are rebased on counts that binning, tiling or culling cannot change:

  * hits: the (ray, candidate) pairs the plain reference composites for
    the image's rays, every pass of the tail chain, in the configuration's
    compositing order down to transmittance 1e-4;
  * the scene's bytes, each surfel read once (and its gradient written
    once in the backward);
  * each ray's inputs read once and its outputs written once.

Each hit is counted once as an intersection in each direction: the least
work is one intersection per composited pair, whatever the kernels visit.
"""

from __future__ import annotations

import json
import os

PAIR_FLOPS = 30
FWD_HIT_FLOPS = 120
BWD_HIT_FLOPS = 230
BWD_SH_FLOPS = 96
SURFEL_FLOATS = 3 + 4 + 2 + 1 + 48     # means, quat, scales, opacity, sh
RAY_IN_FLOATS = 5                       # direction, min depth, t0
RAY_OUT_FLOATS = 10                     # channels and raw transmittance
# Chamfer: one squared distance (3 subtractions, 3 multiply-adds) and a
# compare per pair of points, both directions.
CHAMFER_PAIR_FLOPS = 8
# Adam per parameter: moments, bias corrections, square root, update.
ADAM_FLOPS = 12

_PEAKS = os.path.join(os.path.dirname(__file__), "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named `kind` (peaks.json); raises
    for a card the table lacks."""
    with open(_PEAKS) as f:
        table = json.load(f)
    for name, row in table["cards"].items():
        if name == kind or kind.startswith(name):
            return row
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")


def tracer(hits: int, rays: int, surfels: int) -> dict:
    """The least work of one render's forward and backward: float32 and
    TF32 operations, and bytes, of each."""
    fwd_bytes = 4 * (SURFEL_FLOATS * surfels
                     + (RAY_IN_FLOATS + RAY_OUT_FLOATS) * rays)
    bwd_bytes = 4 * (2 * SURFEL_FLOATS * surfels
                     + (RAY_IN_FLOATS + 2 * RAY_OUT_FLOATS) * rays)
    return {
        "fwd_f32": hits * (PAIR_FLOPS + FWD_HIT_FLOPS), "fwd_tf32": 0,
        "fwd_bytes": fwd_bytes,
        "bwd_f32": hits * (PAIR_FLOPS + BWD_HIT_FLOPS - BWD_SH_FLOPS),
        "bwd_tf32": hits * BWD_SH_FLOPS, "bwd_bytes": bwd_bytes}


def least_seconds(f32: float, tf32: float, nbytes: float, pk: dict
                  ) -> float:
    """The roofline: the larger of the operations' time and the bytes'."""
    ops = f32 / pk["f32_flops"] + tf32 / pk["tf32_flops"]
    return max(ops, nbytes / pk["bytes_per_s"])


def tracer_least_seconds(w: dict, pk: dict) -> float:
    """Forward and backward kernels each at their own roofline."""
    return (least_seconds(w["fwd_f32"], w["fwd_tf32"], w["fwd_bytes"], pk)
            + least_seconds(w["bwd_f32"], w["bwd_tf32"], w["bwd_bytes"],
                            pk))


def ops_seconds(f32: float, tf32: float, pk: dict) -> float:
    """The operations alone at the peak rates: the numerator of MFU."""
    return f32 / pk["f32_flops"] + tf32 / pk["tf32_flops"]


def chamfer_flops(points_a: int, points_b: int) -> int:
    return 2 * points_a * points_b * CHAMFER_PAIR_FLOPS


def adam_flops(params: int) -> int:
    return params * ADAM_FLOPS
