"""Open-loop request arrival streams for online serving.

PyTorch port's copy of ``repro/runtime/arrivals.py`` over the port's
own ``Request``: the same stamps from the same seed (numpy's
generator), the same validation.

The closed-batch protocol (``ChunkedServer.serve``) hands the engine
every request up front, so throughput is the only number it can
produce — queueing never happens and latency under load is invisible.
Production serving is *open-loop*: requests arrive on their own clock
whether or not the engine is keeping up, and the number a serving
stack is judged by is "what arrival rate can it sustain inside a
latency SLO?" (obs/slo.py).  This module builds the arrival side of
that question:

  * ``TimedRequest`` — a ``runtime.server.Request`` stamped with its
    arrival time (seconds from the stream epoch, t=0 = stream start);
  * ``poisson_stream`` — memoryless arrivals at a target rate
    (exponential inter-arrival gaps, the standard open-loop load
    model: bursts and lulls at every timescale, unlike a uniform
    pacer);
  * ``trace_stream`` — replay explicit arrival offsets (e.g. recorded
    production timestamps, or hand-built worst cases for tests);
  * ``closed_stream`` — every request at t=0.  Serving this through
    ``serve_online`` must reproduce the closed-batch path bit for bit
    (same admission order, same greedy outputs, same compiled
    programs) — it is the A/B anchor the online-overhead and parity
    gates compare against.

Everything here is host-side numpy/python — arrival times are wall-
clock scheduling intent, they never become device operands.  The serving
loop (``ChunkedServer.serve_online``) releases a request to the
admission queue when the monotonic clock passes its stamp and records
the *arrival* time as the request's enqueue timestamp, so queue delay
(and therefore TTFT) is measured from arrival, not from when the
scheduler got around to looking at the queue.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.server import Request

__all__ = ["TimedRequest", "poisson_stream", "trace_stream",
           "closed_stream", "offered_rate"]


@dataclasses.dataclass
class TimedRequest:
    """One open-loop arrival: a request plus its arrival offset
    (seconds from the stream epoch; the serving loop anchors the epoch
    to its own monotonic clock at loop start)."""

    t_arrival: float
    request: Request


def _as_stream(reqs: Sequence[Request], times: Iterable[float]
               ) -> List[TimedRequest]:
    stream = [TimedRequest(float(t), r) for t, r in zip(times, reqs)]
    # stable sort: simultaneous arrivals keep their request order, so
    # a closed stream admits in exactly the closed-batch order
    stream.sort(key=lambda tr: tr.t_arrival)
    return stream


def poisson_stream(reqs: Sequence[Request], rate: float, *,
                   seed: int = 0) -> List[TimedRequest]:
    """Stamp ``reqs`` with Poisson-process arrivals at ``rate``
    requests/second: i.i.d. exponential gaps with mean ``1/rate``,
    first arrival one gap after the epoch.  Deterministic per seed so
    rate sweeps and A/B runs replay identical traffic.

    Convention, pinned (the tests hold it against a cumsum of the same
    draws): arrival k lands at
    ``cumsum(gaps)[k]``, so the FIRST request arrives one full gap
    after t=0, never at the epoch itself.  This keeps
    ``offered_rate``'s ``n / t_last`` denominator spanning exactly the
    n gaps that produced the n arrivals — stamping request 0 at t=0
    instead would count n arrivals over n-1 gaps and overstate offered
    load by ~1/n, skewing every rate sweep low-n point."""
    if not np.isfinite(rate) or rate <= 0:
        raise ValueError(f"arrival rate must be finite and > 0, "
                         f"got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(reqs))
    return _as_stream(reqs, np.cumsum(gaps))


def trace_stream(reqs: Sequence[Request],
                 times: Sequence[float]) -> List[TimedRequest]:
    """Stamp ``reqs`` with explicit arrival offsets (a recorded
    production trace, or a hand-built pattern).  Offsets are seconds
    from the epoch and must be non-negative and finite."""
    if len(times) != len(reqs):
        raise ValueError(f"{len(reqs)} requests but {len(times)} "
                         f"arrival times")
    ts = np.asarray(times, np.float64)
    if len(ts) and (not np.all(np.isfinite(ts)) or ts.min() < 0):
        raise ValueError("arrival times must be finite and >= 0")
    return _as_stream(reqs, ts)


def closed_stream(reqs: Sequence[Request]) -> List[TimedRequest]:
    """Every request arrives at t=0 — the open-loop encoding of the
    closed batch.  ``serve_online`` on this stream admits in the same
    order as ``serve`` and must produce bit-identical greedy outputs
    from the same compiled programs."""
    return _as_stream(reqs, [0.0] * len(reqs))


def offered_rate(stream: Sequence[TimedRequest]) -> Optional[float]:
    """Realized arrival rate of a stream: requests per second over the
    [0, last-arrival] span — the same ``arrival_span_s`` denominator
    ``ChunkedServer.serve_online`` reports, so the two numbers agree
    by construction.  ``None`` when the span is zero (closed stream /
    single arrival) — offered load is unbounded, not a rate."""
    if not stream:
        return None
    t_last = max(tr.t_arrival for tr in stream)
    if t_last <= 0:
        return None
    return len(stream) / t_last
