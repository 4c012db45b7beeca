"""The moe and vlm families through the port's servers, against the
reference's, on the CPU (reduced moonshot-v1-16b-a3b, dbrx-132b and
internvl2-1b; the reference's weights bridged by `convert.from_reference`).

`ChunkedServer` (paged bf16, an e4m3 pool, spec decode K=3 greedy and
sampled, `paged=False`) and `SlotServer` serve the same seeded mixes as
the reference's servers.  The bar (test_torch_server.py's and
test_torch_spec.py's):

* `compile_counts()` exactly equal; host stats (admission, pool, prefix
  cache, steps, spans, tokens) exactly equal, the spec stats, the
  copy-on-write resolves and the pool after the wave (block tables,
  refcounts, cached blocks) where no stream parted (acceptance and
  rollback follow the tokens);
* token streams equal, except that a stream may part where the
  reference's own choice is within MARGIN (FP8_MARGIN with an e4m3
  pool) of another: greedy, its top-2 logits; sampled, the top two of
  z + g or the top-k cut, within margin / temperature.  A moe layer
  couples the rows of a call (capacity counts every row, drops follow
  the batch), so once one stream parts the co-batched rows change, as
  with fp8 linears: for moe only the partings of the first parting call
  are held to the margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.models.sampling import SamplingParams as RefParams
from repro.runtime import server as ref_server
from repro_torch.configs import reduced_config
from repro_torch.models import convert
from repro_torch.models.sampling import SamplingParams
from repro_torch.runtime import server

ARCHS = ("moonshot-v1-16b-a3b", "dbrx-132b", "internvl2-1b")
MARGIN = 0.0625                  # test_torch_server.py's margins
FP8_MARGIN = 0.5
SAMPLED = dict(temperature=0.8, top_k=8)

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8)

EXACT_STATS = ("admission_stalls", "peak_blocks_in_use",
               "prefix_hit_requests", "prefix_cached_tokens",
               "cache_evictions", "cached_blocks", "chunk_steps",
               "decode_spans", "prompt_tokens_total", "prefill_tokens",
               "decode_tokens", "tokens", "requests")
SPEC_STATS = ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens")

MIXES = {
    "sharegpt": lambda mod: mod.sharegpt_like_requests(
        6, 256, max_input=16, max_output=8, seed=3),
    "sysprompt": lambda mod: mod.sysprompt_sharegpt_requests(
        6, 256, num_templates=2, template_len=12, max_input=20,
        max_output=6, seed=4),
    "repetitive": lambda mod: mod.repetitive_requests(
        6, 256, motif_len=4, reps=3, max_output=12, seed=5),
}

# case: (mix, server options, sampled); the spec decode cases run from
# test_torch_moe_spec_serving.py, so a test run spreads them over
# another worker
CASES = {
    "paged": ("sharegpt", dict(), False),
    "fp8_kv": ("sysprompt", dict(fp8_kv=True), False),
    "contiguous": ("sharegpt", dict(paged=False), False),
}
SPEC_CASES = {
    "spec3": ("repetitive", dict(spec_decode=3), False),
    "spec3-sampled": ("repetitive", dict(spec_decode=3), True),
}


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    name = request.param
    ref_cfg, cfg = ref_reduced_config(name), reduced_config(name)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


def _record(srv, rec, logits, index) -> None:
    """Each occupied slot's logits under (rid, output index of the token
    drawn at emission position `index`), with the head call's number; a
    verify call's rows each under their own position."""
    rec["calls"] = rec.get("calls", 0) + 1
    logits = np.asarray(logits, np.float32)
    index = np.asarray(index)
    if index.ndim == 1:
        logits, index = logits[:, None], index[:, None]
    for s, r in enumerate(srv.slot_req):
        if r is not None:
            for j in range(index.shape[1]):
                rec[(r.rid, int(index[s, j]) - len(r.prompt))] = (
                    rec["calls"], logits[s, j])


def _spy_reference(monkeypatch, ref_srv, rec) -> None:
    orig = ref_server.sampling.sample_tokens

    def spy(logits, temp, top_k, top_p, seed, index):
        jax.debug.callback(lambda lg, ix: _record(ref_srv, rec, lg, ix),
                           logits, index)
        return orig(logits, temp, top_k, top_p, seed, index)

    monkeypatch.setattr(ref_server.sampling, "sample_tokens", spy)


def _draw_margins(lg, sp, index):
    """The top-2 gap of the reference's z + g (z = logits / temperature,
    top-k masked) and its k-th to (k+1)-th gap of z (test_torch_spec)."""
    z = (lg / np.float32(sp.temperature)).astype(np.float32)
    kgap = np.inf
    if 0 < sp.top_k < z.shape[-1]:
        desc = np.sort(z)[::-1]
        kgap = float(desc[sp.top_k - 1] - desc[sp.top_k])
        z = np.where(z >= desc[sp.top_k - 1], z, -np.inf).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.int32(sp.seed)),
                             jnp.int32(index))
    s = z + np.asarray(jax.random.gumbel(key, z.shape, jnp.float32))
    top = np.sort(s[np.isfinite(s)])
    return float(top[-1] - top[-2]), kgap


def _partings(reqs, ref_reqs, rec):
    """(call, rid, output index, reference logits, request index) of
    every stream's first parting."""
    out = []
    for i, (r, rr) in enumerate(zip(reqs, ref_reqs)):
        assert r.done and rr.done
        if r.output != rr.output:
            n = min(len(r.output), len(rr.output))
            j = next((k for k in range(n) if r.output[k] != rr.output[k]), n)
            call, lg = rec[(rr.rid, j)]
            out.append((call, r.rid, j, lg, i))
    return out


def _hold_partings(cfg, reqs, partings, margin, sampled, label) -> None:
    first = min((p[0] for p in partings), default=0)
    for call, rid, j, lg, i in partings:
        if cfg.family == "moe" and call > first:
            continue
        if sampled:
            gaps = _draw_margins(lg, reqs[i].sampling,
                                 len(reqs[i].prompt) + j)
            assert min(gaps) <= margin / SAMPLED["temperature"], \
                (label, rid, j, gaps)
        else:
            top = np.sort(lg)
            assert top[-1] - top[-2] <= margin, (label, rid, j)
    print(f"{label}: {len(partings)}/{len(reqs)} streams parted, "
          f"{sum(p[0] == first for p in partings)} at the first parting "
          f"call")


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_server_matches_reference(weights, case, monkeypatch):
    chunked_case(weights, case, CASES[case], monkeypatch)


def chunked_case(weights, case, spec, monkeypatch) -> None:
    """Serve `spec` = (mix, options, sampled) through both packages'
    ChunkedServer and hold the port to the reference."""
    ref_cfg, jp, cfg, tp = weights
    mix, opts, sampled = spec
    ref_reqs, reqs = MIXES[mix](ref_server), MIXES[mix](server)
    if sampled:
        for i, (r, rr) in enumerate(zip(reqs, ref_reqs)):
            r.sampling = SamplingParams(seed=100 + i, **SAMPLED)
            rr.sampling = RefParams(seed=100 + i, **SAMPLED)
    ref_srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **KW,
                                       **opts)
    rec = {}
    _spy_reference(monkeypatch, ref_srv, rec)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.ChunkedServer(cfg, tp, device="cpu", **KW, **opts)
    stats = srv.serve(reqs)
    monkeypatch.undo()
    assert srv.compile_counts() == ref_srv.compile_counts()
    assert set(stats) == set(ref_stats)
    partings = _partings(reqs, ref_reqs, rec)
    exact = [k for k in EXACT_STATS if k in ref_stats]
    if opts.get("spec_decode"):
        # steps and spans follow the acceptance, which follows the tokens
        assert stats["spec_steps"] > 0
        exact = (exact + list(SPEC_STATS) if not partings
                 else ["prompt_tokens_total", "requests", "tokens"])
    for key in exact:
        assert stats[key] == ref_stats[key], (key, stats[key],
                                              ref_stats[key])
    if opts.get("paged", True) and not partings:
        assert (srv.metrics.counter_value("serving.cow.resolves")
                == ref_srv.metrics.counter_value("serving.cow.resolves"))
        # the pool after the wave: tables, refcounts, cached blocks
        assert np.array_equal(srv.block_table, ref_srv.block_table)
        assert np.array_equal(srv.pool.refcount, ref_srv.pool.refcount)
        assert np.array_equal(srv.pool.cached, ref_srv.pool.cached)
    margin = FP8_MARGIN if opts.get("fp8_kv") else MARGIN
    _hold_partings(cfg, reqs, partings, margin, sampled,
                   f"{cfg.name} {case}")


def test_slot_server_matches_reference(weights, monkeypatch):
    """SlotServer: compile_counts() and token counts equal, streams by
    the margin rule (a parting held at the logits the reference's
    decode program returned there)."""
    ref_cfg, jp, cfg, tp = weights
    make = lambda mod: mod.sharegpt_like_requests(        # noqa: E731
        5, 256, max_input=8, max_output=6, seed=2)
    ref_reqs, reqs = make(ref_server), make(server)
    kw = dict(batch_slots=3, max_len=32)
    ref_srv = ref_server.SlotServer(ref_cfg, jp, **kw)
    rec = {"calls": 0}
    orig_admit, orig_decode = ref_srv.admit, ref_srv._decode

    def admit(req, slot):
        lg = orig_admit(req, slot)
        rec["calls"] += 1
        rec[(req.rid, 0)] = (rec["calls"], np.asarray(lg, np.float32))
        return lg

    def decode(p, c, t, pos):
        lg, c = orig_decode(p, c, t, pos)
        rec["calls"] += 1
        for s, r in enumerate(ref_srv.slot_req):
            if r is not None:
                rec[(r.rid, len(r.output))] = (rec["calls"],
                                               np.asarray(lg[s], np.float32))
        return lg, c

    monkeypatch.setattr(ref_srv, "admit", admit)
    monkeypatch.setattr(ref_srv, "_decode", decode)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.SlotServer(cfg, tp, device="cpu", **kw)
    stats = srv.serve(reqs)
    monkeypatch.undo()
    assert set(stats) == set(ref_stats)
    assert stats["tokens"] == ref_stats["tokens"]
    assert srv.compile_counts() == ref_srv.compile_counts()
    _hold_partings(cfg, reqs, _partings(reqs, ref_reqs, rec), MARGIN,
                   False, f"{cfg.name} slot")


def test_paged_equals_contiguous_in_the_port(weights):
    """Within the port, the paged and contiguous layouts give the same
    tokens on one batch (masked positions weigh exactly 0 and both
    layouts run the same [slots, chunk] windows, so every moe call sees
    the same rows)."""
    _, _, cfg, tp = weights
    reqs = MIXES["sharegpt"](server)
    paged, contiguous = (server.clone_requests(reqs) for _ in range(2))
    server.ChunkedServer(cfg, tp, device="cpu", **KW).serve(paged)
    server.ChunkedServer(cfg, tp, device="cpu", paged=False,
                         **KW).serve(contiguous)
    assert all(r.done for r in paged)
    assert [r.output for r in paged] == [r.output for r in contiguous]
