"""SLO attainment, goodput, and max-sustainable-rate search.

PyTorch port's copy of ``repro/obs/slo.py`` (pure Python over the
tracer's records; the same definitions, the same values).  These are
the quantities a serving benchmark gates on, so their definitions are
fixed here precisely:

**SLO spec.**  ``SLOSpec(ttft_s, tpot_s)`` — deadlines on time-to-
first-token and time-per-output-token, in seconds.

**Per-request attainment.**  A *finished* request meets the SLO iff

    ttft_s <= slo.ttft_s   AND   (n_out < 2  OR  tpot_s <= slo.tpot_s)

where TTFT is measured from *arrival* (the open-loop enqueue stamp,
runtime/arrivals.py) — queueing time counts against the deadline —
and TPOT is the mean inter-token time after the first
(``(t_done - t_first_token) / (n_out - 1)``, obs/tracer.py).  A
single-token response has no inter-token gaps, so only its TTFT
deadline applies.  ``attainment(tracer, slo)`` is the fraction of
finished requests that meet the SLO; it is NaN when nothing finished
(a run that served nothing did not "attain 100%").  Requests still in
flight at trace time have no verdict and are excluded from plain
``attainment`` — but NOT silently: they are counted in ``unfinished``
and charged as misses by ``attainment_strict`` =
``met / (finished + unfinished)``, because a totally overloaded run
that finishes 2 of 200 requests must not report attainment 1.0 from
the two that squeaked through.  ``attainment_strict`` (NaN only when
nothing was issued at all) is the one to gate on; on run-to-completion
streams unfinished == 0 and the two metrics coincide.

**Goodput.**  Output tokens from SLO-met requests per wall-second:

    goodput_tok_s = sum(n_out for met requests) / wall_s

Tokens produced for a request that blew its deadline are real work
but worthless to its user, so they count toward throughput and not
goodput; the throughput-goodput gap is the cost of SLO violations in
token units.

**Max sustainable rate.**  ``max_sustainable_rate`` sweeps an
arrival-rate grid through a caller-supplied ``run_at_rate`` (which
serves a Poisson stream at that rate and reports attainment) and
returns the highest swept rate whose attainment is >= the target —
the knee of the latency-throughput curve at the chosen SLO, the one
number an open-loop serving stack is judged by.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.obs.tracer import RequestRecord, Tracer

__all__ = ["SLOSpec", "request_met", "attainment", "goodput",
           "slo_report", "max_sustainable_rate"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Latency deadlines, seconds: TTFT from arrival, TPOT mean
    inter-token after the first."""

    ttft_s: float
    tpot_s: float

    def __post_init__(self):
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise ValueError(
                f"SLO deadlines must be > 0, got ttft_s={self.ttft_s} "
                f"tpot_s={self.tpot_s}")


def request_met(rec: RequestRecord, slo: SLOSpec) -> Optional[bool]:
    """Whether one finished request met the SLO; None if unfinished
    (no verdict yet, excluded from attainment)."""
    if rec.ttft_s is None:
        return None
    if rec.ttft_s > slo.ttft_s:
        return False
    tpot = rec.tpot_s  # None when n_out < 2: only TTFT applies
    return tpot is None or tpot <= slo.tpot_s


def attainment(tracer: Tracer, slo: SLOSpec) -> Dict[str, float]:
    """Fraction of finished requests meeting the SLO (docstring above
    for the exact predicate), with a per-deadline breach breakdown."""
    finished = met = unfinished = ttft_miss = tpot_miss = 0
    for rec in tracer.request_records():
        verdict = request_met(rec, slo)
        if verdict is None:
            # no verdict yet: excluded from plain attainment, but a
            # request still stuck in queue at trace time is the most
            # severe miss there is — attainment_strict charges it
            unfinished += 1
            continue
        finished += 1
        if verdict:
            met += 1
        else:
            if rec.ttft_s > slo.ttft_s:
                ttft_miss += 1
            if rec.tpot_s is not None and rec.tpot_s > slo.tpot_s:
                tpot_miss += 1
    issued = finished + unfinished
    return {"finished": finished, "met": met,
            "unfinished": unfinished,
            "attainment": (met / finished if finished
                           else float("nan")),
            "attainment_strict": (met / issued if issued
                                  else float("nan")),
            "ttft_misses": ttft_miss, "tpot_misses": tpot_miss}


def goodput(tracer: Tracer, slo: SLOSpec,
            wall_s: float) -> Dict[str, float]:
    """Output tokens from SLO-met requests per wall-second, next to
    the plain throughput so the gap (tokens burned on requests that
    blew their deadline) is explicit."""
    if wall_s <= 0:
        raise ValueError(f"wall_s must be > 0, got {wall_s}")
    good = total = 0
    for rec in tracer.request_records():
        verdict = request_met(rec, slo)
        if verdict is None:
            continue
        total += rec.n_out
        if verdict:
            good += rec.n_out
    return {"good_tokens": good, "finished_tokens": total,
            "goodput_tok_s": good / wall_s,
            "throughput_tok_s": total / wall_s}


def slo_report(tracer: Tracer, slo: SLOSpec,
               wall_s: float) -> Dict[str, float]:
    """attainment + goodput in one flat dict (one rate's record of a
    rate sweep)."""
    out = {"slo_ttft_s": slo.ttft_s, "slo_tpot_s": slo.tpot_s}
    out.update(attainment(tracer, slo))
    out.update(goodput(tracer, slo, wall_s))
    return out


def max_sustainable_rate(
        run_at_rate: Callable[[float], Dict[str, Any]],
        rates: Sequence[float], *,
        target_attainment: float = 0.99) -> Dict[str, Any]:
    """Sweep ``rates`` (requests/s) through ``run_at_rate`` and find
    the highest rate that still attains the SLO.

    ``run_at_rate(rate)`` must serve an open-loop stream at that rate
    and return a dict containing ``attainment_strict`` (preferred; it
    charges unfinished requests) or ``attainment`` (e.g.
    ``slo_report`` supplies both).  Returns the knee
    (``max_sustainable_rps``, NaN if no swept rate attains the target)
    plus the full sweep trajectory — every swept rate stays in it with
    an ``attained`` verdict, so callers can plot the attainment cliff
    rather than trust a single point.  A NaN attainment (nothing
    finished at that rate — the server drowned) is an explicit miss,
    never a silently dropped row: a rate that serves nothing must not
    be skipped over while a lower rate stands as "sustainable" beyond
    it, and an all-NaN sweep yields a NaN knee, not a crash.
    """
    if not rates:
        raise ValueError("need at least one rate to sweep")
    sweep: List[Dict[str, Any]] = []
    best = float("nan")
    for rate in sorted(rates):
        rep = dict(run_at_rate(rate))
        rep["rate_rps"] = rate
        att = rep.get("attainment_strict",
                      rep.get("attainment", float("nan")))
        attained = (not math.isnan(att)) and att >= target_attainment
        rep["attained"] = attained
        sweep.append(rep)
        if attained:
            best = rate
    return {"max_sustainable_rps": best,
            "target_attainment": target_attainment,
            "sweep": sweep}
