"""Per-request lifecycle tracer for the serving runtime.

The instrumented scheduler calls the tracer at every host-side
transition and around every device dispatch, and the tracer appends
(t, kind, args) tuples plus maintains one ``RequestRecord`` per
request id.  Event and metric names are those of the reference
package, so the same views read either.

Instrumentation convention:

  * timestamps are host-monotonic (``time.perf_counter``) taken ONLY
    around device work units — t0 before the call, t1 after
    ``torch.cuda.synchronize()`` — never on a value that would force
    an extra device sync;
  * event args are plain python scalars/tuples already resident on the
    host (the scheduler's numpy mirrors), never tensors;
  * when tracing is off the scheduler holds ``NULL_TRACER`` whose
    methods are no-ops and whose ``enabled`` flag lets call sites skip
    arg construction entirely (``if self.obs.enabled: ...``).

Event kinds recorded by runtime/server.py (+ prefix_cache / spec):

  enqueue admit prefix_match chunk_dispatch span_dispatch
  verify_dispatch spec_rollback cow_resolve eviction first_token
  finish harvest stall
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry, NULL_METRICS

__all__ = ["RequestRecord", "Tracer", "NullTracer", "NULL_TRACER"]


class RequestRecord:
    """Lifecycle timestamps + token accounting for one request."""

    __slots__ = ("rid", "t_enqueue", "t_admit", "t_first_token",
                 "t_done", "n_prompt", "n_out", "max_output",
                 "cached_tokens", "truncated", "slot")

    def __init__(self, rid: int):
        self.rid = rid
        self.t_enqueue: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.n_prompt = 0
        self.n_out = 0
        self.max_output = 0
        self.cached_tokens = 0
        self.truncated = False
        self.slot = -1

    # -- derived latencies (None until the defining events landed) ------
    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_enqueue is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if (self.t_done is None or self.t_first_token is None
                or self.n_out < 2):
            return None
        return (self.t_done - self.t_first_token) / (self.n_out - 1)

    @property
    def queue_delay_s(self) -> Optional[float]:
        if self.t_admit is None or self.t_enqueue is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_done is None or self.t_enqueue is None:
            return None
        return self.t_done - self.t_enqueue

    def to_dict(self) -> Dict[str, Any]:
        return {"rid": self.rid, "t_enqueue": self.t_enqueue,
                "t_admit": self.t_admit,
                "t_first_token": self.t_first_token,
                "t_done": self.t_done, "n_prompt": self.n_prompt,
                "n_out": self.n_out, "max_output": self.max_output,
                "cached_tokens": self.cached_tokens,
                "truncated": self.truncated, "slot": self.slot,
                "ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
                "queue_delay_s": self.queue_delay_s,
                "e2e_s": self.e2e_s}


class Tracer:
    """Append-only event log + per-request records + metrics registry.

    ``clock`` is injectable for deterministic tests; production uses
    the monotonic ``time.perf_counter``.
    """

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.clock = clock
        self.events: List[Tuple[float, str, dict]] = []
        self.requests: Dict[int, RequestRecord] = {}
        # server constants stamped once at construction (block_size,
        # kv_heads, head_dim, num_layers, span, chunk, B, ...): the
        # derived roofline view needs them next to the events
        self.meta: Dict[str, Any] = {}

    def now(self) -> float:
        return self.clock()

    def clear(self) -> None:
        """Drop events + records (keeps meta); resets metrics."""
        self.events.clear()
        self.requests.clear()
        self.metrics.reset()

    # -- generic event ---------------------------------------------------
    def event(self, kind: str, t: Optional[float] = None, **args) -> None:
        self.events.append((self.clock() if t is None else t, kind, args))

    def span(self, kind: str, t0: float, t1: float, **args) -> None:
        """A timed dispatch: recorded as one event carrying t0/dur."""
        args["dur_s"] = t1 - t0
        self.events.append((t0, kind, args))

    # -- request lifecycle ----------------------------------------------
    def _rec(self, rid: int) -> RequestRecord:
        r = self.requests.get(rid)
        if r is None:
            r = self.requests[rid] = RequestRecord(rid)
        return r

    def enqueue(self, rid: int, n_prompt: int, max_output: int,
                t: Optional[float] = None) -> None:
        """``t`` lets the open-loop serving path stamp the request's
        *scheduled arrival* instead of the observation time: a request
        that arrived mid-dispatch is only seen by the scheduler after
        ``block_until_ready()``, but its queue delay (and TTFT) must
        be charged from arrival (runtime/arrivals.py)."""
        if t is None:
            t = self.clock()
        r = self._rec(rid)
        r.t_enqueue = t
        r.n_prompt = n_prompt
        r.max_output = max_output
        self.events.append((t, "enqueue", {"rid": rid,
                                           "n_prompt": n_prompt}))

    def admit(self, rid: int, slot: int, cached_tokens: int,
              truncated: bool) -> None:
        t = self.clock()
        r = self._rec(rid)
        r.t_admit = t
        r.slot = slot
        r.cached_tokens = cached_tokens
        r.truncated = truncated
        self.events.append((t, "admit",
                            {"rid": rid, "slot": slot,
                             "cached_tokens": cached_tokens}))

    def first_token(self, rid: int) -> None:
        t = self.clock()
        r = self._rec(rid)
        if r.t_first_token is None:
            r.t_first_token = t
            self.events.append((t, "first_token", {"rid": rid}))

    def finish(self, rid: int, n_out: int) -> None:
        t = self.clock()
        r = self._rec(rid)
        if r.t_done is None:
            r.t_done = t
            r.n_out = n_out
            self.events.append((t, "finish",
                                {"rid": rid, "n_out": n_out}))

    # -- export helpers --------------------------------------------------
    def request_records(self) -> List[RequestRecord]:
        return [self.requests[k] for k in sorted(self.requests)]


class NullTracer:
    """All-no-op stand-in held by an un-traced server.

    ``enabled=False`` lets instrumentation sites skip building event
    args; the methods still exist so call sites never branch on None.
    Carries the shared ``NULL_METRICS`` so ``tracer.metrics`` is always
    a registry-shaped object.
    """

    enabled = False
    metrics = NULL_METRICS
    events: List[Tuple[float, str, dict]] = []
    requests: Dict[int, RequestRecord] = {}
    meta: Dict[str, Any] = {}

    def now(self) -> float:
        return 0.0

    def clear(self) -> None:
        pass

    def event(self, kind: str, t: Optional[float] = None, **args) -> None:
        pass

    def span(self, kind: str, t0: float, t1: float, **args) -> None:
        pass

    def enqueue(self, rid: int, n_prompt: int, max_output: int,
                t: Optional[float] = None) -> None:
        pass

    def admit(self, rid: int, slot: int, cached_tokens: int,
              truncated: bool) -> None:
        pass

    def first_token(self, rid: int) -> None:
        pass

    def finish(self, rid: int, n_out: int) -> None:
        pass

    def request_records(self) -> List[RequestRecord]:
        return []


NULL_TRACER = NullTracer()
