"""Time-windowed telemetry: turn the tracer's event stream into
per-window series an operator can put on a dashboard (and Perfetto
counter tracks, obs/export.py).

The request-level views (obs/views.py) answer "how did the run do
overall"; an *open-loop* run (runtime/arrivals.py +
``ChunkedServer.serve_online``) also needs "how did the engine do
*over time*" — a burst that doubles queue depth for two seconds is
invisible in whole-run percentiles but is exactly what an SLO breach
looks like.  ``window_series`` slices the trace into fixed
``window_s`` buckets and reduces each one independently:

  * throughput — packed prefill tokens + emitted decode tokens of the
    dispatches *starting* in the window, as tokens/s;
  * chunk occupancy / span utilization — means over the window's
    dispatches (the same definitions the run-level metrics use);
  * queue depth — enqueue/admit events replayed as a running counter
    (depth at window end plus the in-window max), matching the live
    ``serving.queue.depth`` gauge;
  * stall rate and prefix hit rate — per-window counts of the
    admission-stall and prefix-lookup events;
  * TTFT / TPOT percentiles — over the requests that *finished* in
    the window (nearest-rank, via obs/views.percentiles).

Everything is a pure post-hoc reduction over host-side events —
nothing here runs during serving.  Windows with no traffic are kept
(a dashboard needs the gap), with their undefined statistics
NaN-marked by ``views.percentiles``'s empty-input contract rather
than silently zero.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.obs.tracer import Tracer
from repro_torch.obs.views import percentiles

__all__ = ["window_series", "window_summary"]

# dispatch-event kinds and the args key holding their token work
_DISPATCH_TOKENS = {"chunk_dispatch": "packed_tokens",
                    "span_dispatch": "emitted",
                    "verify_dispatch": "emitted"}


def window_series(tracer: Tracer, window_s: float, *,
                  t0: Optional[float] = None,
                  t1: Optional[float] = None) -> List[Dict[str, Any]]:
    """Reduce the trace into consecutive ``window_s``-second buckets.

    ``t0``/``t1`` default to the first event timestamp and the last
    event *end* (start + duration for timed dispatches).  Events are
    assigned to the window containing their start time.  Returns one
    dict per window with relative ``t_start``/``t_end`` (seconds from
    ``t0``) — an empty trace yields an empty list.
    """
    if window_s <= 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    events = sorted(tracer.events, key=lambda e: e[0])
    if not events:
        return []
    lo = events[0][0] if t0 is None else t0
    hi = (max(t + args.get("dur_s", 0.0) for t, _k, args in events)
          if t1 is None else t1)
    n_windows = max(1, math.ceil(max(hi - lo, 0.0) / window_s))
    meta = tracer.meta
    chunk_cap = meta.get("batch_slots", 0) * meta.get("chunk", 0)
    span_cap = meta.get("batch_slots", 0) * meta.get("span", 0)

    windows: List[Dict[str, Any]] = []
    for i in range(n_windows):
        windows.append({
            "t_start": i * window_s, "t_end": (i + 1) * window_s,
            "tokens": 0, "dispatches": 0, "busy_s": 0.0,
            "arrivals": 0, "admissions": 0, "finished": 0,
            "stalls": 0, "prefix_lookups": 0, "prefix_hits": 0,
            "_occ": [], "_util": [],
            "queue_depth_end": 0, "queue_depth_max": 0,
            "_ttft": [], "_tpot": [],
        })

    def _bucket(t: float) -> Dict[str, Any]:
        return windows[min(max(int((t - lo) / window_s), 0),
                           n_windows - 1)]

    depth = 0
    for t, kind, args in events:
        w = _bucket(t)
        if kind in _DISPATCH_TOKENS:
            w["dispatches"] += 1
            w["busy_s"] += args.get("dur_s", 0.0)
            w["tokens"] += int(args.get(_DISPATCH_TOKENS[kind], 0))
            if kind == "chunk_dispatch" and chunk_cap:
                w["_occ"].append(
                    args.get("packed_tokens", 0) / chunk_cap)
            elif kind == "span_dispatch" and span_cap:
                w["_util"].append(
                    args.get("emitted", 0)
                    / (span_cap * max(args.get("steps", 1), 1)
                       / max(meta.get("span", 1), 1)))
        elif kind == "enqueue":
            w["arrivals"] += 1
            depth += 1
            w["queue_depth_max"] = max(w["queue_depth_max"], depth)
        elif kind == "admit":
            w["admissions"] += 1
            depth = max(depth - 1, 0)
        elif kind == "stall":
            w["stalls"] += 1
        elif kind == "prefix_lookup":
            w["prefix_lookups"] += 1
            w["prefix_hits"] += int(args.get("matched_tokens", 0) > 0)
        elif kind == "finish":
            w["finished"] += 1
        # depth is a running value: every event after the last
        # enqueue/admit in a window sees the final state, so stamp it
        # on the window containing this event
        w["queue_depth_end"] = depth

    for rec in tracer.request_records():
        if rec.t_done is None:
            continue
        w = _bucket(rec.t_done)
        if rec.ttft_s is not None:
            w["_ttft"].append(rec.ttft_s)
        if rec.tpot_s is not None:
            w["_tpot"].append(rec.tpot_s)

    nan = float("nan")
    for w in windows:
        occ, util = w.pop("_occ"), w.pop("_util")
        w["tokens_per_s"] = w["tokens"] / window_s
        w["busy_frac"] = w["busy_s"] / window_s
        w["chunk_occupancy"] = (sum(occ) / len(occ)) if occ else nan
        w["span_utilization"] = (sum(util) / len(util)) if util else nan
        w["prefix_hit_rate"] = (w["prefix_hits"] / w["prefix_lookups"]
                                if w["prefix_lookups"] else nan)
        w["ttft_s"] = percentiles(w.pop("_ttft"))
        w["tpot_s"] = percentiles(w.pop("_tpot"))
    return windows


def window_summary(windows: List[Dict[str, Any]]
                   ) -> Dict[str, Any]:
    """Whole-run rollup of a window series: nearest-rank percentiles
    of the per-window throughput (the number that exposes burst
    sensitivity — a flat p50≈p99 is a steady engine), total stalls,
    and the peak queue depth.  Empty series yield a count-0,
    NaN-marked summary (views.percentiles contract)."""
    return {
        "n_windows": len(windows),
        "tokens_per_s": percentiles(
            [w["tokens_per_s"] for w in windows]),
        "busy_frac": percentiles([w["busy_frac"] for w in windows]),
        "stalls": sum(w["stalls"] for w in windows),
        "peak_queue_depth": max(
            (w["queue_depth_max"] for w in windows), default=0),
    }
