"""Port vs reference: the scheduler fuzz harness (runtime/fuzz.py).

The port's ``run_fuzz_trace(seed)`` drives its own ChunkedServer
(allocator, radix tree, copy-on-write, spec rollback, backpressure)
with model-free work units that draw from the seed's generator in the
reference's order; every request's output, the audit count, the
prefix-cache hits, evictions, stalls, copy-on-write resolves and
rollback blocks must equal the reference's exactly.  The reference's
traces are computed once per module.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.runtime import fuzz as ref_fuzz
from repro_torch.runtime import fuzz

# the reference's seeded tier (tests/test_prefix_cache.py) and more
SEEDS = [0, 1, 2, 7, 19, 42, 3, 5, 6, 100, 2024, 12345]


COUNTERS = ("serving.cow.resolves", "serving.spec.rollback_blocks",
            "serving.admission.stalls", "serving.requests.admitted",
            "serving.dispatches.prefill", "serving.dispatches.span")


def _traced(module, seed, **kw):
    """What run_fuzz_trace did: each wave's request outputs (in order)
    and scheduler counters (the server resets them every wave), then
    the audits and the cache's totals."""
    waves = []
    cls = module.AuditedChunkedServer
    orig = cls.serve

    def serve(self, reqs):
        stats = orig(self, reqs)
        waves.append({
            "outputs": [list(map(int, r.output)) for r in reqs],
            "counters": {k: self.metrics.counter(k).value for k in COUNTERS},
            "prefix_hits": self.prefix_hits,
            "cached_prompt_tokens": self.cached_prompt_tokens,
            "peak_blocks": self.peak_blocks,
            "stalls": self.admission_stalls})
        return stats

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "serve", serve)
        srv = module.run_fuzz_trace(seed, **kw)
    return {"waves": waves, "audits": srv.audits,
            "evicted": srv.prefix_cache.evicted_blocks,
            "knobs": (srv.B, srv.max_len, srv.chunk, srv.span,
                      srv.block_size, srv.num_blocks, srv.eos_id,
                      srv.spec_decode)}


def _total(reading, key, counter=False):
    return sum(w["counters"][key] if counter else w[key]
               for w in reading["waves"])


@pytest.fixture(scope="module")
def ref_traces():
    return {seed: _traced(ref_fuzz, seed) for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_trace_equals_the_reference(seed, ref_traces):
    got = _traced(fuzz, seed, device="cpu")
    want = ref_traces[seed]
    assert got == want
    assert got["audits"] > 0 and got["waves"][0]["outputs"]


def test_fuzz_traces_cover_the_scheduler(ref_traces):
    """Over the seeds the traces reach copy-on-write, prefix hits,
    evictions, spec rollbacks and backpressure (so the equality above
    holds those paths, not idle ones)."""
    readings = [_traced(fuzz, seed, device="cpu") for seed in SEEDS]
    assert readings == [ref_traces[s] for s in SEEDS]
    assert sum(_total(r, "prefix_hits") for r in readings) > 0
    assert sum(r["evicted"] for r in readings) > 0
    assert sum(_total(r, "stalls") for r in readings) > 0
    for key in ("serving.cow.resolves", "serving.spec.rollback_blocks"):
        assert sum(_total(r, key, counter=True) for r in readings) > 0, key


def test_audit_catches_a_leak():
    """The audit is live: a block taken from the pool behind the
    scheduler's back (owned by no slot) fails the next audit."""
    srv = fuzz.AuditedChunkedServer(
        fuzz.fuzz_config(16), rng=np.random.default_rng(0), batch_slots=2,
        max_len=16, chunk=4, span=2, block_size=4, num_blocks=8,
        device="cpu")
    srv._audit()
    srv.pool.alloc()
    with pytest.raises(AssertionError, match="refcount"):
        srv._audit()


@given(st.integers(0, 2 ** 32 - 1), st.integers(1, 3), st.integers(2, 8))
@settings(max_examples=12, deadline=None)
def test_fuzz_equals_the_reference_on_random_traffic(seed, waves, n):
    """Hypothesis-widened (as tests/test_property.py widens the
    reference's tier): random seeds, wave counts and wave sizes give the
    reference's trace exactly."""
    kw = dict(waves=waves, requests_per_wave=n)
    assert _traced(fuzz, seed, device="cpu", **kw) == \
        _traced(ref_fuzz, seed, **kw)
