"""Trace exports: JSONL structured events and Chrome trace-event JSON.

``write_jsonl`` emits one JSON object per line — a ``meta`` line, one
``request`` line per lifecycle record, then every raw event in time
order — grep/jq-friendly and append-mergeable across runs.

``write_chrome_trace`` emits the Chrome trace-event format (the JSON
array flavor) loadable in Perfetto / chrome://tracing: timed dispatch
events (``dur_s`` present) become "X" complete events on a per-phase
track, instant events become "i" marks, and each request's
admit->done window becomes an "X" on a per-slot track so queueing,
prefill and decode phases line up visually.  With ``window_s`` set,
the obs/windows.py per-window series additionally becomes "C"
counter tracks (tokens/s, queue depth, occupancy/utilization, stall
and prefix-hit rates) so load and engine health plot as graphs above
the dispatch timeline.
"""

from __future__ import annotations

import json
import math
from typing import Dict

from repro_torch.obs.tracer import Tracer

__all__ = ["write_jsonl", "write_chrome_trace"]


def _scalar(o):
    """json default= hook: numpy scalars slip into event args from the
    scheduler's mirrors; coerce anything with .item() to its python
    value instead of failing the export."""
    item = getattr(o, "item", None)
    if item is not None:
        return item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")

# phase track ids: stable ordering in the viewer
_PHASE_TIDS = {"chunk_dispatch": 1, "span_dispatch": 2,
               "verify_dispatch": 3}
_SLOT_TID0 = 10


def write_jsonl(tracer: Tracer, path: str) -> int:
    """Write meta + request records + events; returns lines written."""
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", **tracer.meta},
                            default=_scalar) + "\n")
        n += 1
        for rec in tracer.request_records():
            f.write(json.dumps({"type": "request", **rec.to_dict()},
                               default=_scalar) + "\n")
            n += 1
        for t, kind, args in sorted(tracer.events, key=lambda e: e[0]):
            f.write(json.dumps({"type": "event", "t": t, "kind": kind,
                                **args}, default=_scalar) + "\n")
            n += 1
    return n


def _us(t: float, t0: float) -> float:
    return (t - t0) * 1e6


# (counter name, window_series key) -> one "C" track each
_COUNTER_TRACKS = (
    ("tokens/s", "tokens_per_s"),
    ("queue depth", "queue_depth_end"),
    ("chunk occupancy", "chunk_occupancy"),
    ("span utilization", "span_utilization"),
    ("stalls", "stalls"),
    ("prefix hit rate", "prefix_hit_rate"),
)


def _counter_events(tracer: Tracer, window_s: float) -> list:
    """Per-window "C" counter samples (Perfetto draws step graphs).

    Each window contributes one sample per track at its start time;
    NaN-marked values (empty window, views.percentiles contract) are
    skipped rather than serialized — NaN is not legal JSON and would
    plot as a bogus zero anyway.
    """
    from repro_torch.obs.windows import window_series
    out = []
    for w in window_series(tracer, window_s):
        ts = w["t_start"] * 1e6
        for name, key in _COUNTER_TRACKS:
            v = w[key]
            if isinstance(v, float) and math.isnan(v):
                continue
            out.append({"ph": "C", "pid": 1, "name": name,
                        "ts": ts, "args": {name: v}})
    return out


def write_chrome_trace(tracer: Tracer, path: str, *,
                       window_s: float = 0.0) -> int:
    """Write Chrome trace-event JSON; returns events written.
    ``window_s > 0`` adds the windowed counter tracks."""
    events = sorted(tracer.events, key=lambda e: e[0])
    if not events:
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f, default=_scalar)
        return 0
    t0 = events[0][0]
    out = []
    # track names
    for name, tid in (("prefill chunk_step", 1), ("decode_span", 2),
                      ("spec verify_step", 3)):
        out.append({"ph": "M", "pid": 1, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})
    for t, kind, args in events:
        if "dur_s" in args:
            a = {k: v for k, v in args.items() if k != "dur_s"}
            # tuples aren't JSON; lists are
            a = {k: list(v) if isinstance(v, tuple) else v
                 for k, v in a.items()}
            out.append({"ph": "X", "pid": 1,
                        "tid": _PHASE_TIDS.get(kind, 4),
                        "name": kind, "ts": _us(t, t0),
                        "dur": args["dur_s"] * 1e6, "args": a})
        else:
            a = {k: list(v) if isinstance(v, tuple) else v
                 for k, v in args.items()}
            out.append({"ph": "i", "pid": 1, "tid": 0, "s": "g",
                        "name": kind, "ts": _us(t, t0), "args": a})
    # per-request admit->done windows on per-slot tracks
    slot_seen: Dict[int, bool] = {}
    for rec in tracer.request_records():
        if rec.t_admit is None or rec.t_done is None:
            continue
        tid = _SLOT_TID0 + max(rec.slot, 0)
        if tid not in slot_seen:
            slot_seen[tid] = True
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"slot {rec.slot}"}})
        out.append({"ph": "X", "pid": 1, "tid": tid,
                    "name": f"req {rec.rid}",
                    "ts": _us(rec.t_admit, t0),
                    "dur": max(rec.t_done - rec.t_admit, 0.0) * 1e6,
                    "args": {"rid": rec.rid, "n_prompt": rec.n_prompt,
                             "n_out": rec.n_out,
                             "cached_tokens": rec.cached_tokens,
                             "ttft_s": rec.ttft_s,
                             "tpot_s": rec.tpot_s}})
    if window_s > 0:
        out.extend(_counter_events(tracer, window_s))
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f,
                  default=_scalar)
    return len(out)
