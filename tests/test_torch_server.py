"""Port `ChunkedServer` (CPU) vs reference `ChunkedServer(kernel=False)`.

Both serve the same seeded request mixes with the same weights (the
reference's init, bridged with `convert.from_reference`), with a bf16
KV pool, an e4m3 pool (`fp8_kv`), and an e4m3 pool with fp8 linears
(`fp8_kv` + `fp8_linear`).  The bar:

* host-side state is EXACTLY equal: admission stalls, peak blocks in
  use, prefix hits and cached tokens, evictions, resident blocks, chunk
  steps, decode spans, copy-on-write resolves, each output's length;
* token streams are identical, except that a stream may part at a step
  where the reference's own top-2 logit margin is within MARGIN — there
  the two frameworks' bf16 logits (one rounding step apart, see
  test_torch_transformer.py) may pick either token — or FP8_MARGIN with
  fp8 options.  The test reads the reference's logits at the step where
  a stream parts from its own serving run (a spy on its sample head),
  checks the margin, and reports how many streams parted.  With fp8
  linears the activation scale is one per call over the whole batch,
  so once one stream parts the other slots' inputs, and scales,
  change: only the partings of the first parting call are held to the
  margin there;
* the fp8 pool holds exactly (hd+4)/(2*hd) of the bf16 pool's bytes.
"""

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
# fp8 modes: e4m3 turns a one-step bf16 difference of a k/v value or
# an activation into a one-step e4m3 difference (16x larger), and a
# per-tensor activation scale moves with a one-step change of its max;
# teacher-forced logits of the fp8 forward differ from the reference's
# by up to ~0.45 here (test_torch_transformer.test_teacher_forced_fp8)
FP8_MARGIN = 0.5

EXACT_STATS = ("admission_stalls", "peak_blocks_in_use",
               "prefix_hit_requests", "prefix_cached_tokens",
               "cache_evictions", "cached_blocks", "chunk_steps",
               "decode_spans", "prompt_tokens_total", "prefill_tokens",
               "decode_tokens", "tokens", "pool_blocks")

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8)

FP8_MODES = {"bf16": dict(), "fp8_kv": dict(fp8_kv=True),
             "fp8_kv_linear": dict(fp8_kv=True, fp8_linear=True)}

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


def _record(srv, rec, logits, emit_pos) -> None:
    """Store each occupied slot's logits under (rid, index of the output
    token emitted at sequence position `emit_pos`), with the number of
    the head call.  Slots mid-prompt get negative indices, finished
    slots in a span indices past their output: neither is read."""
    rec["calls"] = rec.get("calls", 0) + 1
    logits, emit_pos = np.asarray(logits, np.float32), np.asarray(emit_pos)
    for s, r in enumerate(srv.slot_req):
        if r is not None:
            rec[(r.rid, int(emit_pos[s]) - len(r.prompt))] = (rec["calls"],
                                                              logits[s])


def _spy_reference(monkeypatch, ref_srv, rec) -> None:
    """Record the reference server's logits at every sample-head call
    (a host callback in its jitted work units)."""
    orig = ref_server.sampling.sample_tokens

    def spy(logits, temp, top_k, top_p, seed, index):
        jax.debug.callback(lambda lg, ix: _record(ref_srv, rec, lg, ix),
                           logits, index)
        return orig(logits, temp, top_k, top_p, seed, index)

    monkeypatch.setattr(ref_server.sampling, "sample_tokens", spy)


# the bf16 cases keep the bare mix as their id
@pytest.mark.parametrize("mix,mode", [
    pytest.param(m, f, id=m if f == "bf16" else f"{m}-{f}")
    for f in FP8_MODES for m in sorted(MIXES)])
def test_served_outputs_and_host_state_match_reference(weights, mix, mode,
                                                       monkeypatch):
    ref_cfg, jp, cfg, tp = weights
    extra, make = MIXES[mix]
    fp8 = FP8_MODES[mode]
    kw = dict(KW, **extra)
    ref_reqs, reqs = make(ref_server), make(server)
    ref_srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **kw,
                                       **fp8)
    ref_rec = {}
    _spy_reference(monkeypatch, ref_srv, ref_rec)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.ChunkedServer(cfg, tp, device="cpu", **kw, **fp8)
    stats = srv.serve(reqs)
    if fp8:
        bf16_bytes = server.ChunkedServer(
            cfg, tp, device="cpu", **kw).serve([])["kv_bytes_per_device"]
        hd = cfg.head_dim
        assert stats["kv_bytes_per_device"] / bf16_bytes == \
            (hd + 4) / (2 * hd)
        assert stats["kv_bytes_per_device"] == \
            ref_stats["kv_bytes_per_device"]

    for key in EXACT_STATS:
        assert stats[key] == ref_stats[key], (key, stats[key],
                                              ref_stats[key])
    assert (srv.metrics.counter_value("serving.cow.resolves")
            == ref_srv.metrics.counter_value("serving.cow.resolves"))
    if mix == "tight_pool":
        assert stats["admission_stalls"] > 0
        assert stats["cache_evictions"] > 0
        assert srv.metrics.counter_value("serving.cow.resolves") > 0
    partings = []
    for r, rr in zip(reqs, ref_reqs):
        assert r.done and rr.done
        assert len(r.output) == len(rr.output), r.rid
        if r.output != rr.output:
            j = next(i for i, (a, b) in enumerate(zip(r.output, rr.output))
                     if a != b)
            call, lg = ref_rec[(rr.rid, j)]
            assert int(lg.argmax()) == rr.output[j]
            partings.append((call, r.rid, j, lg, r.output[j]))
    # with fp8 linears a parting changes the co-batched slots' inputs,
    # and so every later activation scale: only the first parting
    # call is held to the margin
    first = min((p[0] for p in partings), default=0)
    margin = MARGIN if mode == "bf16" else FP8_MARGIN
    for call, rid, j, lg, tok in partings:
        if "fp8_linear" in fp8 and call > first:
            continue
        top = np.sort(lg)
        assert top[-1] - top[-2] <= margin, (mix, rid, j, top[-1] - top[-2])
        assert lg.max() - lg[tok] <= margin, (mix, rid, j)
    print(f"{mix} {mode}: {len(partings)}/{len(reqs)} streams parted, "
          f"{sum(p[0] == first for p in partings)} at the first parting "
          f"call, where the reference's top-2 margin <= {margin}")


def test_metrics_and_tracer_names(weights):
    """The registry and tracer carry the reference's names, the verify
    work unit's and spec decode's too."""
    from repro_torch.obs.tracer import Tracer
    _, _, cfg, tp = weights
    tracer = Tracer()
    srv = server.ChunkedServer(cfg, tp, device="cpu", tracer=tracer,
                               **dict(KW, max_len=40, num_blocks=9))
    srv.serve(server.sysprompt_sharegpt_requests(
        10, 256, num_templates=2, template_len=12, max_input=20,
        max_output=12, seed=4))
    spec_tracer = Tracer()
    spec_srv = server.ChunkedServer(cfg, tp, device="cpu",
                                    tracer=spec_tracer, spec_decode=3, **KW)
    spec_srv.serve(server.repetitive_requests(6, 256, motif_len=4, reps=3,
                                              max_output=12, seed=5))
    snap = spec_tracer.metrics.snapshot()
    assert {"serving.dispatches.verify", "serving.spec.drafted",
            "serving.spec.accepted", "serving.spec.emitted",
            "serving.spec.rollback_blocks"} <= set(snap["counters"])
    assert {"serving.wall_s.verify", "serving.spec.tokens_per_slot",
            "serving.spec.accept_rate"} <= set(snap["histograms"])
    assert {"verify_dispatch", "spec_rollback"} <= {
        e[1] for e in spec_tracer.events}
    assert spec_tracer.meta["spec_decode"] == 3
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
    fp8_tracer = Tracer()
    server.ChunkedServer(cfg, tp, device="cpu", tracer=fp8_tracer,
                         fp8_kv=True, **KW)
    assert fp8_tracer.meta["kv_read_mode"] == "fp8_kernel"


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
    """Tensor parallelism is ported (tests/test_torch_tp.py): tp=2 with
    no visible CUDA devices and no explicit spread raises, and fp8
    linears refuse tp > 1, as the reference's; the contiguous layout
    refuses an fp8 pool as the reference does."""
    from repro_torch.launch.mesh import make_tp_mesh
    _, _, cfg, tp = weights
    with pytest.raises(ValueError, match="spread"):
        server.ChunkedServer(cfg, tp, device="cpu", tp=2)
    with pytest.raises(NotImplementedError):
        server.ChunkedServer(cfg, tp, mesh=make_tp_mesh(2, spread="cpu"),
                             fp8_linear=True)
    with pytest.raises(ValueError, match="paged"):
        server.ChunkedServer(cfg, tp, device="cpu", paged=False,
                             fp8_kv=True)


def test_requests_match_reference_generators():
    for a, b in zip(server.sharegpt_like_requests(5, 100, seed=7),
                    ref_server.sharegpt_like_requests(5, 100, seed=7)):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
    for a, b in zip(server.sysprompt_sharegpt_requests(5, 100, seed=7),
                    ref_server.sysprompt_sharegpt_requests(5, 100, seed=7)):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
    for a, b in zip(server.repetitive_requests(6, 100, motif_len=5, seed=7),
                    ref_server.repetitive_requests(6, 100, motif_len=5,
                                                   seed=7)):
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
    assert set(before) == {"paged_decode", "paged_chunk",
                           "paged_decode_fp8", "paged_chunk_fp8"}
    assert isinstance(srv.cur_tok, torch.Tensor)

