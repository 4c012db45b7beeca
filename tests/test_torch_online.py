"""Open-loop serving of the port against the reference, on the CPU.

* arrival streams (`runtime/arrivals.py`): the port's stamps equal the
  reference's bit for bit (both draw numpy's generator from the same
  seed), in the same order, with the same validation errors (the cases
  of the reference's tests/test_online.py);
* `ChunkedServer.serve_online` on a closed stream equals `serve`: the
  same admission order, streams and `compile_counts()`, with the paged
  and the contiguous layout, spec decode and sampling; its stats keys
  are the reference's; on a Poisson stream the queue delay is charged
  from the scheduled arrival;
* `obs/{slo,views,windows,export}.py` and `core/roofline.py`: fed the
  same synthetic event log through each package's tracer (an injected
  clock), every view, window, SLO figure and model equals the
  reference's, and the JSONL and Chrome-trace files are equal byte for
  byte;
* the CLI's online flags (`--arrival-rate`, `--duration`,
  `--slo-ttft-ms`, `--slo-tpot-ms`, `--trace`, `--trace-out`,
  `--engine`, `--contiguous`) with `--device cpu`, and the reference's
  refusals.
"""

import math

import jax
import numpy as np
import pytest

from repro import obs as ref_obs
from repro.configs import reduced_config as ref_reduced_config
from repro.core import roofline as ref_roofline
from repro.models import api as ref_api
from repro.runtime import arrivals as ref_arrivals
from repro.runtime import server as ref_server
from repro_torch import obs
from repro_torch.configs import reduced_config
from repro_torch.core import roofline
from repro_torch.launch import serve as serve_cli
from repro_torch.models import api
from repro_torch.models.sampling import SamplingParams
from repro_torch.runtime import arrivals, server


def _reqs(mod, n=5, seed=0):
    return mod.sharegpt_like_requests(n, 256, max_input=12, max_output=6,
                                      seed=seed)


# ----------------------------------------------------------------------
# arrival streams
# ----------------------------------------------------------------------

def _stamps(stream):
    return [(tr.t_arrival, tr.request.rid) for tr in stream]


@pytest.mark.parametrize("n,rate,seed", [(8, 4.0, 7), (6, 2.0, 11),
                                         (500, 10.0, 0), (1, 0.3, 5)])
def test_poisson_stamps_equal_reference(n, rate, seed):
    port = arrivals.poisson_stream(_reqs(server, n), rate, seed=seed)
    ref = ref_arrivals.poisson_stream(_reqs(ref_server, n), rate, seed=seed)
    assert _stamps(port) == _stamps(ref)
    assert all(type(tr.t_arrival) is float for tr in port)
    assert arrivals.offered_rate(port) == ref_arrivals.offered_rate(ref)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
    assert [tr.t_arrival for tr in port] == list(np.cumsum(gaps))


def test_trace_and_closed_streams_equal_reference():
    times = [2.0, 0.5, 1.0, 0.5]
    assert _stamps(arrivals.trace_stream(_reqs(server, 4), times)) == \
        _stamps(ref_arrivals.trace_stream(_reqs(ref_server, 4), times))
    closed = arrivals.closed_stream(_reqs(server, 4))
    assert _stamps(closed) == _stamps(
        ref_arrivals.closed_stream(_reqs(ref_server, 4)))
    assert arrivals.offered_rate(closed) is None
    assert arrivals.offered_rate([]) is None
    assert isinstance(closed[0].request, server.Request)


BAD_STREAMS = {
    "rate_zero": lambda m, r: m.poisson_stream(r, 0.0),
    "rate_negative": lambda m, r: m.poisson_stream(r, -1.0),
    "rate_nan": lambda m, r: m.poisson_stream(r, float("nan")),
    "rate_inf": lambda m, r: m.poisson_stream(r, float("inf")),
    "trace_length": lambda m, r: m.trace_stream(r, [0.0, 1.0]),
    "trace_negative": lambda m, r: m.trace_stream(r, [0.0, -1.0, 2.0]),
    "trace_nan": lambda m, r: m.trace_stream(r, [0.0, float("nan"), 2.0]),
}


@pytest.mark.parametrize("case", sorted(BAD_STREAMS))
def test_stream_validation_errors_equal_reference(case):
    make = BAD_STREAMS[case]
    with pytest.raises(ValueError) as port:
        make(arrivals, _reqs(server, 3))
    with pytest.raises(ValueError) as ref:
        make(ref_arrivals, _reqs(ref_server, 3))
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------
# serve_online
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced_config("yi-6b")
    return cfg, api.init(cfg, 0, device="cpu")


SRV = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
           device="cpu")
ONLINE_CASES = {
    "paged": dict(),
    "contiguous": dict(paged=False),
    "spec": dict(spec_decode=3),
    "contiguous_spec": dict(paged=False, spec_decode=3),
    "sampled": dict(sampling=SamplingParams(temperature=0.8, top_k=20,
                                            seed=7)),
}


def _admissions(tracer):
    return [(a["rid"], a["slot"]) for _, kind, a in tracer.events
            if kind == "admit"]


@pytest.mark.parametrize("case", sorted(ONLINE_CASES))
def test_serve_online_closed_stream_equals_serve(model, case):
    cfg, params = model
    kw = dict(SRV, **ONLINE_CASES[case])
    reqs = server.sharegpt_like_requests(6, cfg.vocab_size, max_input=16,
                                         max_output=8, seed=3)
    a, b = server.clone_requests(reqs), server.clone_requests(reqs)
    ta, tb = obs.Tracer(), obs.Tracer()
    srv_a = server.ChunkedServer(cfg, params, tracer=ta, **kw)
    srv_b = server.ChunkedServer(cfg, params, tracer=tb, **kw)
    closed = srv_a.serve(a)
    online = srv_b.serve_online(arrivals.closed_stream(b))
    assert [r.output for r in a] == [r.output for r in b]
    assert _admissions(ta) == _admissions(tb)
    assert srv_a.compile_counts() == srv_b.compile_counts()
    for key in ("requests", "tokens", "chunk_steps", "decode_spans",
                "prefill_tokens", "decode_tokens", "compiled_programs"):
        assert online[key] == closed[key], key
    assert online["online"] == 1.0
    assert online["arrival_span_s"] == 0.0
    assert online["offered_rate_rps"] == 0.0    # unbounded, not a rate
    assert online["peak_queue_depth"] == 6      # all six at t=0, 3 slots
    assert online["idle_s"] == 0.0              # a closed stream never naps
    assert set(online) - set(closed) == {"online", "arrival_span_s",
                                         "offered_rate_rps", "idle_s",
                                         "peak_queue_depth"}


def test_serve_online_stats_keys_equal_reference(model):
    ref_cfg = ref_reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    cfg, params = model
    kw = dict(batch_slots=2, max_len=32, chunk=8, span=4)
    for paged in (True, False):
        ref = ref_server.ChunkedServer(ref_cfg, jp, paged=paged, **kw)
        ref_st = ref.serve_online(ref_arrivals.closed_stream(
            _reqs(ref_server, 2)))
        port = server.ChunkedServer(cfg, params, paged=paged, device="cpu",
                                    **kw)
        st = port.serve_online(arrivals.closed_stream(_reqs(server, 2)))
        assert set(st) == set(ref_st), paged


def test_serve_online_poisson_charges_queue_delay_from_arrival(model):
    cfg, params = model
    reqs = server.sharegpt_like_requests(5, cfg.vocab_size, max_input=12,
                                         max_output=6, seed=5)
    tracer = obs.Tracer()
    srv = server.ChunkedServer(cfg, params, tracer=tracer, **SRV)
    srv.serve(server.clone_requests(reqs))      # warm-up
    counts = srv.compile_counts()
    tracer.clear()
    run = server.clone_requests(reqs)
    stream = arrivals.poisson_stream(run, rate=200.0, seed=1)
    stats = srv.serve_online(stream)
    ref = server.clone_requests(reqs)
    server.ChunkedServer(cfg, params, **SRV).serve(ref)
    assert [r.output for r in ref] == [r.output for r in run]
    assert srv.compile_counts() == counts
    assert stats["requests"] == len(reqs)
    assert stats["offered_rate_rps"] == pytest.approx(
        arrivals.offered_rate(stream))
    recs = tracer.request_records()
    assert len(recs) == len(reqs)
    # the enqueue stamps are the scheduled arrivals, epoch-anchored
    by_rid = {tr.request.rid: tr.t_arrival for tr in stream}
    t0 = recs[0].t_enqueue - by_rid[recs[0].rid]
    for r in recs:
        assert r.t_enqueue - t0 == pytest.approx(by_rid[r.rid], abs=1e-9)
        assert r.queue_delay_s is not None and r.queue_delay_s >= 0
        assert r.ttft_s >= r.queue_delay_s
    assert srv.metrics.gauge("serving.queue.depth").samples > 0


class _FakeTime:
    """A clock that moves 0.1 ms a reading and by what `sleep` asks."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-4
        return self.t

    def sleep(self, s):
        self.t += s


def test_serve_online_sleeps_toward_late_arrivals(model, monkeypatch):
    """A stream whose arrivals are spread out (the server's clock made
    deterministic): the loop naps, at most max_idle_sleep_s a time,
    instead of spinning, toward the next stamp, and finishes after the
    last arrival."""
    cfg, params = model
    reqs = server.sharegpt_like_requests(2, cfg.vocab_size, max_input=8,
                                         max_output=2, seed=1)
    srv = server.ChunkedServer(cfg, params, **SRV)
    clock = _FakeTime()
    naps = []
    monkeypatch.setattr(clock, "sleep",
                        lambda s, _s=clock.sleep: (naps.append(s), _s(s)))
    monkeypatch.setattr(server, "time", clock)
    stats = srv.serve_online(arrivals.trace_stream(reqs, [0.0, 0.25]),
                             max_idle_sleep_s=0.01)
    assert all(r.done for r in reqs)
    assert naps and max(naps) <= 0.01
    assert stats["idle_s"] == pytest.approx(sum(naps))
    assert 0.2 < stats["idle_s"] < 0.25
    assert stats["seconds"] >= 0.25
    assert stats["arrival_span_s"] == 0.25
    assert stats["offered_rate_rps"] == 2 / 0.25


# ----------------------------------------------------------------------
# views, windows, SLOs, exports, the roofline model
# ----------------------------------------------------------------------

META = dict(batch_slots=3, chunk=8, span=4, max_len=64, num_layers=2,
            kv_heads=4, head_dim=16, spec_decode=3, tp=1, paged=True,
            block_size=8, max_blocks=8, num_blocks=24)


class _Clock:
    """Deterministic clock: irregular steps from a seeded draw."""

    def __init__(self, seed):
        self.steps = iter(np.random.default_rng(seed).uniform(
            1e-4, 0.02, size=10000).tolist())
        self.t = 100.0

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def _synthetic_log(pkg, mode):
    """One serving trace driven through `pkg`'s tracer: arrivals at
    Poisson-like stamps, admissions, prefix lookups, a stall, chunk,
    span and verify dispatches with kv_lens, first tokens, finishes,
    one request left unfinished, the registry's counters, histograms
    and gauges, and numpy scalars in event args."""
    clock = _Clock(3)
    tr = pkg.Tracer(clock=clock)
    tr.meta.update(META, kv_read_mode=mode)
    m = tr.metrics
    rng = np.random.default_rng(4)
    for rid in range(9):
        tr.enqueue(rid, int(rng.integers(4, 30)), 8, t=100.0 + 0.01 * rid)
        m.gauge("serving.queue.depth").set(float(9 - rid))
    for rid in range(8):
        tr.admit(rid, rid % 3, int(rng.integers(0, 2)) * 8, rid == 5)
        tr.event("prefix_lookup", rid=rid,
                 matched_tokens=np.int32(8 * (rid % 2)))
        if rid == 4:
            tr.event("stall", rid=rid, needed_blocks=np.int64(3))
        t0 = clock()
        t1 = clock()
        packed = int(rng.integers(1, 24))
        tr.span("chunk_dispatch", t0, t1, packed_tokens=packed,
                n_prefill=2, n_decode=1)
        m.counter("serving.dispatches.prefill").inc()
        m.histogram("serving.wall_s.prefill").record(t1 - t0)
        m.histogram("serving.chunk.occupancy").record(packed / 24)
        m.gauge("serving.pool.blocks_in_use").set(float(rid + 3))
        tr.first_token(rid)
        kv = tuple(int(x) for x in rng.integers(1, 60, size=3))
        kind = "verify_dispatch" if rid % 3 == 2 else "span_dispatch"
        t0 = clock()
        t1 = clock()
        if kind == "span_dispatch":
            tr.span(kind, t0, t1, steps=4, n_active=3, emitted=10,
                    kv_lens=kv)
            m.counter("serving.dispatches.span").inc()
            m.histogram("serving.wall_s.span").record(t1 - t0)
            m.histogram("serving.span.utilization").record(10 / 12)
        else:
            tr.span(kind, t0, t1, k=3, n_active=3, emitted=7,
                    accepted=4, kv_lens=kv)
            m.counter("serving.dispatches.verify").inc()
            m.histogram("serving.wall_s.verify").record(t1 - t0)
        if rid != 6:                                # 6 emits one token
            tr.first_token(rid)
        tr.finish(rid, 1 if rid == 6 else int(rng.integers(2, 9)))
        tr.event("harvest", rid=rid, slot=rid % 3, n_out=np.int64(4))
    return tr                                       # rid 8: unfinished


def _same(a, b):
    """Equal, NaN equal to NaN, tuples and lists alike."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("mode", ["kernel", "fp8_kernel", "gather"])
def test_views_windows_and_slo_equal_reference(mode):
    tr, ref = _synthetic_log(obs, mode), _synthetic_log(ref_obs, mode)
    assert tr.events == ref.events
    for fn in ("request_latency_summary", "roofline_efficiency",
               "summary_table"):
        assert _same(getattr(obs, fn)(tr), getattr(ref_obs, fn)(ref)), fn
    assert obs.roofline_efficiency(tr)["modeled"]
    for fn in ("phase_summary", "occupancy_summary"):
        assert _same(getattr(obs, fn)(tr.metrics),
                     getattr(ref_obs, fn)(ref.metrics)), fn
    for window_s in (0.01, 0.05, 1.0):
        w, rw = obs.window_series(tr, window_s), ref_obs.window_series(
            ref, window_s)
        assert _same(w, rw), window_s
        assert _same(obs.window_summary(w), ref_obs.window_summary(rw))
    assert _same(obs.window_series(tr, 0.02, t0=100.05, t1=100.4),
                 ref_obs.window_series(ref, 0.02, t0=100.05, t1=100.4))
    for ttft, tpot in ((0.05, 0.02), (0.2, 0.01), (1.0, 1.0)):
        slo, rslo = obs.SLOSpec(ttft, tpot), ref_obs.SLOSpec(ttft, tpot)
        rep = obs.slo_report(tr, slo, 0.75)
        assert _same(rep, ref_obs.slo_report(ref, rslo, 0.75))
        assert rep["unfinished"] == 1
        assert [obs.request_met(r, slo) for r in tr.request_records()] == \
            [ref_obs.request_met(r, rslo) for r in ref.request_records()]
    sweep = obs.max_sustainable_rate(
        lambda r: {"attainment_strict": 1.0 / r}, [0.5, 1.0, 2.0, 4.0],
        target_attainment=0.5)
    assert _same(sweep, ref_obs.max_sustainable_rate(
        lambda r: {"attainment_strict": 1.0 / r}, [0.5, 1.0, 2.0, 4.0],
        target_attainment=0.5))
    for bad in (lambda m: m.SLOSpec(0.0, 1.0),
                lambda m: m.window_series(m.Tracer(), 0.0)):
        with pytest.raises(ValueError):
            bad(obs)
        with pytest.raises(ValueError):
            bad(ref_obs)
    assert obs.window_series(obs.Tracer(), 1.0) == []


def test_exports_equal_reference_byte_for_byte(tmp_path):
    tr, ref = _synthetic_log(obs, "kernel"), _synthetic_log(ref_obs,
                                                            "kernel")
    n = obs.write_jsonl(tr, str(tmp_path / "port.jsonl"))
    assert n == ref_obs.write_jsonl(ref, str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    for window_s in (0.0, 0.03):
        m = obs.write_chrome_trace(tr, str(tmp_path / "port.json"),
                                   window_s=window_s)
        assert m == ref_obs.write_chrome_trace(
            ref, str(tmp_path / "ref.json"), window_s=window_s)
        assert (tmp_path / "port.json").read_bytes() == \
            (tmp_path / "ref.json").read_bytes()
    assert obs.write_chrome_trace(obs.Tracer(), str(tmp_path / "e")) == 0


@pytest.mark.parametrize("kv_len", [1, 15, 16, 17, 200])
def test_roofline_model_equals_reference(kv_len):
    kw = dict(block_size=16, max_blocks=17, kv_heads=4, head_dim=128)
    for mode in ("gather", "kernel", "fp8_kernel"):
        assert roofline.paged_decode_kv_bytes(kv_len, mode=mode, **kw) == \
            ref_roofline.paged_decode_kv_bytes(kv_len, mode=mode, **kw)
    assert roofline.paged_decode_speedup(kv_len, **kw) == \
        ref_roofline.paged_decode_speedup(kv_len, **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        roofline.paged_decode_kv_bytes(kv_len, mode="fp8_gather", **kw)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def test_cli_online_flags(tmp_path, capsys):
    prefix = str(tmp_path / "online")
    stats = serve_cli.main([
        "--device", "cpu", "--slots", "2", "--contiguous",
        "--arrival-rate", "40", "--duration", "0.1",
        "--slo-ttft-ms", "60000", "--slo-tpot-ms", "60000",
        "--trace-out", prefix])
    out = capsys.readouterr().out
    assert stats["online"] == 1.0 and stats["requests"] == 4.0
    for line in ("engine=chunked", "open-loop:", "slo:", "goodput:",
                 "windowed(", "wrote", "latency", "attainment=100.00%"):
        assert line in out, line
    assert "paged-kv" not in out                    # contiguous: no pool
    assert (tmp_path / "online.jsonl").stat().st_size > 0
    assert (tmp_path / "online.trace.json").stat().st_size > 0
    stats = serve_cli.main(["--device", "cpu", "--engine", "slot",
                            "--slots", "2", "--requests", "3"])
    out = capsys.readouterr().out
    assert stats["requests"] == 3.0 and "engine=slot" in out
    assert "prefill_one=" in out and "decode_step=1" in out


@pytest.mark.parametrize("argv", [
    ["--slo-ttft-ms", "100"],
    ["--slo-tpot-ms", "100"],
    ["--duration", "2"],
    ["--engine", "slot", "--arrival-rate", "2"],
    ["--engine", "slot", "--trace"],
    ["--engine", "slot", "--spec-decode", "2"],
    ["--engine", "slot", "--fp8-kv"],
    ["--engine", "slot", "--fp8-linear"],
    ["--contiguous", "--fp8-kv"],
], ids=lambda a: "_".join(x.lstrip("-") for x in a))
def test_cli_refusals(argv):
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu"] + argv)
