"""Port `ChunkedServer` (CPU) vs reference `ChunkedServer(kernel=False)`.

Both serve the same seeded request mixes with the same weights (the
reference's init, bridged with `convert.from_reference`).  The bar:

* host-side state is EXACTLY equal: admission stalls, peak blocks in
  use, prefix hits and cached tokens, evictions, resident blocks, chunk
  steps, decode spans, copy-on-write resolves, each output's length;
* token streams are identical, except that a stream may part at a step
  where the reference's own top-2 logit margin is within MARGIN — there
  the two frameworks' bf16 logits (one rounding step apart, see
  test_torch_transformer.py) may pick either token.  The test
  recomputes the reference logits on the prefix where a stream parts,
  checks the margin, and reports how many streams parted.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.runtime import server as ref_server
from repro_torch.configs import reduced_config
from repro_torch.models import convert
from repro_torch.runtime import server

# four bf16 steps at |logit| < 4 (the reduced model's logits are O(1))
MARGIN = 0.0625

EXACT_STATS = ("admission_stalls", "peak_blocks_in_use",
               "prefix_hit_requests", "prefix_cached_tokens",
               "cache_evictions", "cached_blocks", "chunk_steps",
               "decode_spans", "prompt_tokens_total", "prefill_tokens",
               "decode_tokens", "tokens", "pool_blocks")

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8)

MIXES = {
    "sharegpt": (dict(), lambda mod: mod.sharegpt_like_requests(
        6, 256, max_input=16, max_output=8, seed=3)),
    "sysprompt": (dict(), lambda mod: mod.sysprompt_sharegpt_requests(
        6, 256, num_templates=2, template_len=12, max_input=20,
        max_output=6, seed=4)),
    # 9 blocks for 3 slots: admission stalls, LRU evictions, and
    # templates ending mid-block resolve copy-on-write
    "tight_pool": (dict(max_len=40, num_blocks=9),
                   lambda mod: mod.sysprompt_sharegpt_requests(
                       10, 256, num_templates=2, template_len=12,
                       max_input=20, max_output=12, seed=4)),
}


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config("yi-6b")
    cfg = reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


def _ref_logits(ref_cfg, jp, seq):
    """Reference logits after `seq` (chunked prefill of one slot)."""
    C, bs = 8, 8
    MB = -(-len(seq) // bs) + 1
    step = _ref_chunk(ref_cfg)
    cache = ref_api.init_cache(ref_cfg, 1, MB * bs, paged=True,
                               block_size=bs, num_blocks=MB)
    bt = np.arange(MB, dtype=np.int32)[None]
    for off in range(0, len(seq), C):
        toks = np.zeros((1, C), np.int32)
        chunk = np.asarray(seq[off:off + C], np.int32)
        toks[0, :len(chunk)] = chunk
        logits, cache = step(jp, cache, toks, np.array([off], np.int32),
                             np.array([len(chunk)], np.int32), bt)
    return np.asarray(logits[0], np.float32)


@functools.lru_cache(maxsize=None)
def _ref_chunk(ref_cfg):
    return jax.jit(functools.partial(ref_api.chunk_step, ref_cfg))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_served_outputs_and_host_state_match_reference(weights, mix):
    ref_cfg, jp, cfg, tp = weights
    extra, make = MIXES[mix]
    kw = dict(KW, **extra)
    ref_reqs, reqs = make(ref_server), make(server)
    ref_srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **kw)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.ChunkedServer(cfg, tp, device="cpu", **kw)
    stats = srv.serve(reqs)

    for key in EXACT_STATS:
        assert stats[key] == ref_stats[key], (key, stats[key],
                                              ref_stats[key])
    assert (srv.metrics.counter_value("serving.cow.resolves")
            == ref_srv.metrics.counter_value("serving.cow.resolves"))
    if mix == "tight_pool":
        assert stats["admission_stalls"] > 0
        assert stats["cache_evictions"] > 0
        assert srv.metrics.counter_value("serving.cow.resolves") > 0
    parted = 0
    for r, rr in zip(reqs, ref_reqs):
        assert r.done and rr.done
        assert len(r.output) == len(rr.output), r.rid
        if r.output == rr.output:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.output, rr.output))
                 if a != b)
        lg = _ref_logits(ref_cfg, jp,
                         np.concatenate([rr.prompt, rr.output[:j]]))
        top = np.sort(lg)
        assert top[-1] - top[-2] <= MARGIN, (mix, r.rid, j, top[-1] - top[-2])
        assert lg.max() - lg[r.output[j]] <= MARGIN, (mix, r.rid, j)
        parted += 1
    print(f"{mix}: {parted}/{len(reqs)} streams parted at a reference "
          f"top-2 margin <= {MARGIN}")


def test_metrics_and_tracer_names(weights):
    """The registry and tracer carry the reference's names."""
    from repro_torch.obs.tracer import Tracer
    _, _, cfg, tp = weights
    tracer = Tracer()
    srv = server.ChunkedServer(cfg, tp, device="cpu", tracer=tracer,
                               **dict(KW, max_len=40, num_blocks=9))
    srv.serve(server.sysprompt_sharegpt_requests(
        10, 256, num_templates=2, template_len=12, max_input=20,
        max_output=12, seed=4))
    counters = set(tracer.metrics.snapshot()["counters"])
    assert {"serving.dispatches.prefill", "serving.dispatches.span",
            "serving.requests.admitted", "serving.requests.harvested",
            "serving.admission.stalls", "serving.cow.resolves",
            "serving.prefix.lookups", "serving.prefix.hits",
            "serving.prefix.evictions"} <= counters
    kinds = {e[1] for e in tracer.events}
    assert {"enqueue", "admit", "prefix_lookup", "prefix_match",
            "chunk_dispatch", "span_dispatch", "cow_resolve", "eviction",
            "first_token", "finish", "harvest", "stall"} <= kinds
    assert tracer.meta["kv_read_mode"] == "kernel"
    assert all(r.ttft_s is not None for r in tracer.request_records())


def test_eos_stops_like_reference(weights):
    """With eos_id set, a slot stops right after emitting that token
    (the reference's rule) and is otherwise unchanged."""
    ref_cfg, jp, cfg, tp = weights
    base = server.sharegpt_like_requests(6, 256, max_input=16,
                                         max_output=8, seed=3)
    srv = server.ChunkedServer(cfg, tp, device="cpu", **KW)
    srv.serve(base)
    eos = base[0].output[2]                 # a token that is emitted
    reqs = server.clone_requests(base)
    server.ChunkedServer(cfg, tp, device="cpu", eos_id=eos, **KW).serve(reqs)
    for r, b in zip(reqs, base):
        cut = b.output.index(eos) + 1 if eos in b.output else len(b.output)
        assert r.output == b.output[:cut]


def test_deferred_options_raise(weights):
    _, _, cfg, tp = weights
    for kw in (dict(paged=False), dict(spec_decode=2), dict(fp8_kv=True),
               dict(fp8_linear=True), dict(tp=2), dict(sampling=object())):
        with pytest.raises(NotImplementedError):
            server.ChunkedServer(cfg, tp, device="cpu", **kw)


def test_requests_match_reference_generators():
    for a, b in zip(server.sharegpt_like_requests(5, 100, seed=7),
                    ref_server.sharegpt_like_requests(5, 100, seed=7)):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
    for a, b in zip(server.sysprompt_sharegpt_requests(5, 100, seed=7),
                    ref_server.sysprompt_sharegpt_requests(5, 100, seed=7)):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
    c = server.clone_requests(server.sharegpt_like_requests(2, 100))
    assert all(not r.output and not r.done for r in c)


def test_launch_counts_are_the_kernel_wrappers(weights):
    """On the CPU the wrappers run the plain versions and count no
    launch; the server reports the wrappers' counts."""
    _, _, cfg, tp = weights
    srv = server.ChunkedServer(cfg, tp, device="cpu", **KW)
    before = srv.launch_counts()
    srv.serve(server.sharegpt_like_requests(2, 256, max_input=8,
                                            max_output=4))
    assert srv.launch_counts() == before
    assert set(before) == {"paged_decode", "paged_chunk"}
    assert isinstance(srv.cur_tok, torch.Tensor)

