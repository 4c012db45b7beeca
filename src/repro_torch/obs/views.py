"""Derived views over a serving trace: latency percentiles, phase
breakdowns, occupancy/utilization rollups, and a roofline-anchored
efficiency estimate.

These are pure post-hoc reductions over the tracer's host-side event
log and metrics registry — nothing here runs during serving, so the
views can be as expensive as they like without touching the serving
hot path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import roofline
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["percentiles", "request_latency_summary", "phase_summary",
           "occupancy_summary", "roofline_efficiency", "summary_table"]

_QS = (50, 95, 99)


def percentiles(xs: Sequence[float], qs: Sequence[int] = _QS
                ) -> Dict[str, float]:
    """Nearest-rank percentiles + mean.

    An empty input yields ``count=0`` with every statistic NaN-marked:
    a window (or run) with zero finished requests has *undefined*
    latency, and a silent 0.0 would read as an impossibly fast p99
    downstream (dashboards, the regression gate).  Consumers branch on
    ``count`` before comparing.
    """
    if not xs:
        nan = float("nan")
        return {**{f"p{q}": nan for q in qs}, "mean": nan, "count": 0}
    s = sorted(xs)
    out = {}
    for q in qs:
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        out[f"p{q}"] = s[min(rank, len(s)) - 1]
    out["mean"] = sum(s) / len(s)
    out["count"] = len(s)
    return out


def request_latency_summary(tracer: Tracer) -> Dict[str, Dict[str, float]]:
    """TTFT / TPOT / queue-delay / end-to-end percentiles over every
    finished request in the trace (paper-style latency reporting:
    TTFT = first token - enqueue, TPOT = inter-token mean after the
    first)."""
    recs = tracer.request_records()
    cols = {"ttft_s": [], "tpot_s": [], "queue_delay_s": [], "e2e_s": []}
    for r in recs:
        for k in cols:
            v = getattr(r, k)
            if v is not None:
                cols[k].append(v)
    return {k: percentiles(v) for k, v in cols.items()}


def phase_summary(metrics: MetricsRegistry) -> Dict[str, Dict[str, float]]:
    """Per-phase dispatch counts + wall-time totals (prefill chunk
    steps vs decode spans vs spec verify steps), straight from the
    registry the scheduler feeds."""
    out = {}
    for phase in ("prefill", "span", "verify"):
        h = metrics.hist(f"serving.wall_s.{phase}")
        n = metrics.counter_value(f"serving.dispatches.{phase}")
        out[phase] = {
            "dispatches": n,
            "wall_s": h.total if h is not None else 0.0,
            "mean_dispatch_s": (h.total / h.count
                                if h is not None and h.count else 0.0),
        }
    total = sum(p["wall_s"] for p in out.values())
    for p in out.values():
        p["wall_frac"] = p["wall_s"] / total if total > 0 else 0.0
    return out


def occupancy_summary(metrics: MetricsRegistry) -> Dict[str, float]:
    """Chunk-occupancy (packed tokens per chunk_step over B*chunk
    capacity) and span-utilization (productive slot-steps over B*span)
    rollups."""
    out = {}
    occ = metrics.hist("serving.chunk.occupancy")
    util = metrics.hist("serving.span.utilization")
    out["chunk_occupancy_mean"] = occ.mean if occ is not None else 0.0
    out["span_utilization_mean"] = util.mean if util is not None else 0.0
    pool = metrics.gauge("serving.pool.blocks_in_use")
    out["peak_blocks_in_use"] = (pool.peak if pool.samples else 0.0)
    return out


def roofline_efficiency(tracer: Tracer) -> Dict[str, float]:
    """Achieved vs modeled paged-KV decode traffic.

    Each span/verify dispatch event records the active slots' kv_lens
    (host mirror values).  With the server's geometry in
    ``tracer.meta`` we can price every dispatch through
    ``core/roofline.paged_decode_kv_bytes``: the *achieved* read path
    (kernel mode walks only valid blocks; gather mode always touches
    the full extent) vs the gather ceiling.  The ratio is the fraction
    of the gather-path bytes the configured read path actually moved —
    a measurement-anchored efficiency number in the spirit of the
    paper's memory-hierarchy dissection.
    """
    meta = tracer.meta
    need = ("block_size", "max_blocks", "kv_heads", "head_dim",
            "num_layers")
    if not all(k in meta for k in need):
        return {"modeled": False}
    kw = dict(block_size=meta["block_size"],
              max_blocks=meta["max_blocks"], kv_heads=meta["kv_heads"],
              head_dim=meta["head_dim"])
    mode = meta.get("kv_read_mode", "gather")
    layers = meta["num_layers"]
    achieved = modeled_gather = 0.0
    steps = 0
    for _t, kind, args in tracer.events:
        if kind not in ("span_dispatch", "verify_dispatch"):
            continue
        kv_lens = args.get("kv_lens") or ()
        n_steps = args.get("steps", 1)
        for kv in kv_lens:
            if kv <= 0:
                continue
            achieved += layers * n_steps * roofline.paged_decode_kv_bytes(
                int(kv), mode=mode, **kw)
            modeled_gather += (layers * n_steps
                               * roofline.paged_decode_kv_bytes(
                                   int(kv), mode="gather", **kw))
            steps += n_steps
    if steps == 0:
        return {"modeled": False}
    return {"modeled": True, "kv_read_mode": mode,
            "decode_slot_steps": steps,
            "achieved_kv_bytes": achieved,
            "gather_ceiling_bytes": modeled_gather,
            "bytes_vs_gather": (achieved / modeled_gather
                                if modeled_gather else 0.0),
            "mean_kv_bytes_per_step": achieved / steps}


def summary_table(tracer: Tracer) -> str:
    """Human-readable trace summary for launch/serve.py --trace."""
    lines: List[str] = []
    lat = request_latency_summary(tracer)
    phases = phase_summary(tracer.metrics)
    occ = occupancy_summary(tracer.metrics)
    eff = roofline_efficiency(tracer)

    lines.append("  trace: %d events, %d requests"
                 % (len(tracer.events), len(tracer.requests)))
    hdr = f"  {'latency':<14}{'p50':>10}{'p95':>10}{'p99':>10}{'mean':>10}"
    lines.append(hdr)
    for key, label in (("queue_delay_s", "queue-delay"),
                       ("ttft_s", "ttft"), ("tpot_s", "tpot"),
                       ("e2e_s", "e2e")):
        d = lat[key]
        lines.append("  %-14s%10.2f%10.2f%10.2f%10.2f ms"
                     % (label, d["p50"] * 1e3, d["p95"] * 1e3,
                        d["p99"] * 1e3, d["mean"] * 1e3))
    lines.append(f"  {'phase':<14}{'dispatches':>10}{'wall_s':>10}"
                 f"{'frac':>10}")
    for phase, d in phases.items():
        lines.append("  %-14s%10d%10.3f%10.2f"
                     % (phase, d["dispatches"], d["wall_s"],
                        d["wall_frac"]))
    lines.append("  chunk-occupancy=%.2f span-utilization=%.2f "
                 "peak-blocks=%d"
                 % (occ["chunk_occupancy_mean"],
                    occ["span_utilization_mean"],
                    occ["peak_blocks_in_use"]))
    if eff.get("modeled"):
        lines.append("  kv-read=%s achieved=%.2e B vs gather-ceiling="
                     "%.2e B (x%.3f) over %d decode slot-steps"
                     % (eff["kv_read_mode"], eff["achieved_kv_bytes"],
                        eff["gather_ceiling_bytes"],
                        eff["bytes_vs_gather"],
                        eff["decode_slot_steps"]))
    return "\n".join(lines)
