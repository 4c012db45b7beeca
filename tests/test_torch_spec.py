"""Speculative decoding and the sample head in the port's server, on the
CPU, against the reference (repro/runtime/spec_decode.py and its
`ChunkedServer(kernel=False)`), with the reference's weights bridged by
`convert.from_reference`, on the reduced yi-6b.

The bar:

* the n-gram helpers (`ngram_hash`, `propose`, `accept_greedy`,
  `update_ngram`) equal the reference's; where one update holds a
  context twice the reference's choice is its scatter's, and the port's
  rule (the last row in flattened (slot, j) order wins) is checked on
  its own;
* `spec_decode_step`'s bookkeeping (budget, EOS cut, the scatter of the
  emitted window, cur_tok, active, the table) equals the reference's
  for the same model predictions;
* served streams with spec decode (K=3), paged, prefix cache on, on the
  sharegpt, sysprompt and repetitive mixes, greedy and sampled, bf16
  and fp8 (e4m3 pool + fp8 linears), equal the reference's, except that
  a stream may part where the reference's own choice is within the
  margin of test_torch_server.py (greedy: its top-2 logits; sampled:
  the top two of z + g, or the k-th and (k+1)-th largest z at the top-k
  cut, z the logits over the temperature, so within margin /
  temperature); with fp8 linears only the first parting call
  is held to it (one activation scale per call over the batch).  The
  host stats, the spec stats, the rolled-back blocks and the
  copy-on-write resolves are equal where no stream parted;
* within the port: greedy K=3 equals K=0 bitwise, sampled K=3 equals
  sampled K=0 given the seeds, disjoint seeds give K>0 and K=0 token
  distributions a KS test cannot tell apart, and greedy / sampled /
  greedy waves on one server equal three fresh servers;
* the serving CLI takes ``--spec-decode`` and ``--workload repetitive``
  and prints the server's spec stats.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.runtime import server as ref_server
from repro.runtime import spec_decode as ref_spec
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert
from repro_torch.models.sampling import SamplingParams, ks_two_sample
from repro_torch.runtime import server
from repro_torch.runtime import spec_decode as spec

# the margins of tests/test_torch_server.py
MARGIN = 0.0625
FP8_MARGIN = 0.5
K = 3

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
          prefix_cache=True)

EXACT_STATS = ("admission_stalls", "peak_blocks_in_use",
               "prefix_hit_requests", "prefix_cached_tokens",
               "cache_evictions", "cached_blocks", "chunk_steps",
               "decode_spans", "prompt_tokens_total", "prefill_tokens",
               "decode_tokens", "tokens", "pool_blocks", "spec_k",
               "spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
               "spec_acceptance_rate", "spec_tokens_per_step")

MIXES = {
    "sharegpt": lambda mod: mod.sharegpt_like_requests(
        6, 256, max_input=16, max_output=8, seed=3),
    "sysprompt": lambda mod: mod.sysprompt_sharegpt_requests(
        6, 256, num_templates=2, template_len=12, max_input=20,
        max_output=6, seed=4),
    "repetitive": lambda mod: mod.repetitive_requests(
        6, 256, motif_len=4, reps=3, max_output=12, seed=5),
}

MODES = {"bf16": dict(), "fp8": dict(fp8_kv=True, fp8_linear=True)}

SAMPLED = dict(temperature=0.8, top_k=8)


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config("yi-6b")
    cfg = reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------------------
# n-gram helpers
# ----------------------------------------------------------------------

def test_ngram_hash_matches_reference():
    rng = np.random.default_rng(0)
    for vocab, n_ctx in ((256, 32768), (64000, 32768), (300000, 1000)):
        a = rng.integers(0, vocab, 500).astype(np.int32)
        b = rng.integers(0, vocab, 500).astype(np.int32)
        want = np.asarray(ref_spec.ngram_hash(jnp.asarray(a), jnp.asarray(b),
                                              n_ctx))
        got = spec.ngram_hash(_t(a), _t(b), n_ctx)
        np.testing.assert_array_equal(got.numpy(), want)


def test_propose_and_accept_match_reference():
    rng = np.random.default_rng(1)
    B, T, n_ctx = 6, 20, 64
    table = rng.integers(0, 50, (n_ctx, K)).astype(np.int32)
    out_buf = rng.integers(0, 50, (B, T)).astype(np.int32)
    out_len = np.array([0, 1, 2, 5, 19, 20], np.int32)
    cur = rng.integers(0, 50, B).astype(np.int32)
    want = np.asarray(ref_spec.propose(*map(jnp.asarray, (table, cur,
                                                          out_buf, out_len))))
    got = spec.propose(*map(_t, (table, cur, out_buf, out_len)))
    np.testing.assert_array_equal(got.numpy(), want)
    drafts = rng.integers(0, 3, (40, K)).astype(np.int32)
    preds = rng.integers(0, 3, (40, K + 1)).astype(np.int32)
    preds[:10, :K] = drafts[:10]                   # all accepted
    want = np.asarray(ref_spec.accept_greedy(jnp.asarray(drafts),
                                             jnp.asarray(preds)))
    got = spec.accept_greedy(_t(drafts), _t(preds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:10] == K).all()


def _update_inputs(rng, B, T, vocab, unique: bool):
    out_buf = rng.integers(0, vocab, (B, T)).astype(np.int32)
    if unique:                       # distinct tokens: distinct contexts
        out_buf = rng.permutation(B * T).reshape(B, T).astype(np.int32)
    out_len = rng.integers(0, T + 1, B).astype(np.int32)
    out_len[:2] = (T, 3)             # a full buffer; runs into the prompt
    active = rng.random(B) < 0.8
    active[0] = True
    return out_buf, out_len, active


def _last_wins(table, out_buf, out_len, active, n_ctx):
    """The port's rule in plain numpy: rows in (b, j) order, a later
    row with the same context overwrites an earlier one."""
    table = table.copy()
    B, T = out_buf.shape
    for b in range(B):
        for j in range(K + 1):
            p = int(out_len[b]) - K - j
            if not active[b] or p < 2:
                continue
            ctx = (int(out_buf[b, p - 2]) * 7919 + int(out_buf[b, p - 1])) \
                % n_ctx
            table[ctx] = [out_buf[b, min(max(p + i, 0), T - 1)]
                          for i in range(K)]
    return table


@pytest.mark.parametrize("unique", [True, False], ids=["distinct",
                                                       "duplicates"])
def test_update_ngram(unique):
    """Distinct contexts: equal to the reference.  Repeated contexts:
    the port's last-row-wins rule, deterministic across calls."""
    rng = np.random.default_rng(2)
    B, T, n_ctx = 6, 24, 97 if unique else 5
    for _ in range(5):
        out_buf, out_len, active = _update_inputs(rng, B, T, 6, unique)
        table = rng.integers(0, 9, (n_ctx, K)).astype(np.int32)
        got = spec.update_ngram(_t(table), _t(out_buf), _t(out_len),
                                _t(active))
        np.testing.assert_array_equal(
            got.numpy(), _last_wins(table, out_buf, out_len, active, n_ctx))
        if unique:
            want = np.asarray(ref_spec.update_ngram(
                *map(jnp.asarray, (table, out_buf, out_len, active))))
            np.testing.assert_array_equal(got.numpy(), want)
        again = spec.update_ngram(_t(table), _t(out_buf), _t(out_len),
                                  _t(active))
        assert torch.equal(got, again)


def _fake_verify(window, pos, vocab):
    """Model predictions for a bookkeeping test: row j repeats draft
    j+1 (an accepted draft) unless (b + j + pos) % 3 == 2."""
    B, C = window.shape
    b = np.arange(B)[:, None]
    j = np.arange(C)[None, :]
    nxt = np.concatenate([window[:, 1:], window[:, -1:]], axis=1)
    other = (window * 7 + j + 1) % vocab
    hit = ((b + j + pos[:, None]) % 3 != 2) & (j < C - 1)
    return np.where(hit, nxt, other).astype(np.int32)


@pytest.mark.parametrize("eos", [None, 4])
def test_spec_decode_step_bookkeeping_matches_reference(monkeypatch, eos):
    rng = np.random.default_rng(3 if eos is None else 4)
    B, T, n_ctx, vocab, max_len = 6, 24, 31, 9, 28

    def ref_verify(cfg, params, cache, window, pos, bt, sample=None, **kw):
        return jnp.asarray(_fake_verify(np.asarray(window), np.asarray(pos),
                                        vocab)), cache

    def port_verify(cfg, params, cache, window, pos, bt, sample=None, **kw):
        return _t(_fake_verify(window.numpy(), pos.numpy(), vocab)), cache

    monkeypatch.setattr(ref_spec.api, "verify_step", ref_verify)
    monkeypatch.setattr(spec.api, "verify_step", port_verify)
    table = rng.integers(0, vocab, (n_ctx, K)).astype(np.int32)
    out_buf = np.zeros((B, T), np.int32)
    out_len = np.array([1, 2, 5, 9, 12, 1], np.int32)
    for b in range(B):
        out_buf[b, :out_len[b]] = rng.integers(0, vocab, out_len[b])
    cur = out_buf[np.arange(B), out_len - 1].copy()
    pos = (out_len + np.array([3, 8, 4, 10, 12, 2])).astype(np.int32)
    active = np.array([True, True, True, True, True, False])
    max_new = np.array([4, 20, 6, 20, 14, 20], np.int32)   # budgets 0-3+
    samp = (np.zeros(B, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32), np.zeros(B, np.int32))
    rstate = [jnp.asarray(x) for x in (table, cur, out_buf, pos, out_len,
                                       active)]
    pstate = [_t(x.copy()) for x in (table, cur, out_buf, pos, out_len,
                                     active)]
    for step in range(4):
        r = ref_spec.spec_decode_step(
            None, None, None, *rstate, jnp.asarray(max_new),
            *map(jnp.asarray, samp), None, max_len=max_len, eos_id=eos)
        p = spec.spec_decode_step(
            None, None, None, *pstate, _t(max_new), *map(_t, samp), None,
            max_len=max_len, eos_id=eos)
        names = ("table", "cur_tok", "out_buf", "pos", "out_len", "active",
                 "n_emit")
        for name, a, b in zip(names, r[1:], p[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"step {step} {name}")
        rstate = list(r[1:7])
        pstate = list(p[1:7])
    assert not np.asarray(rstate[5]).all()      # budgets and EOS stop slots


# ----------------------------------------------------------------------
# served streams against the reference
# ----------------------------------------------------------------------

def _record(srv, rec, logits, index) -> None:
    """Store each occupied slot's logits under (rid, output index of the
    token drawn at emission position `index`), with the head call's
    number; a verify call's rows each under their own position (a later
    call's record of a position is the one that emitted it)."""
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
    """How near the reference's sampled draw is to another: the top-2
    gap of its z + g (z = logits / temperature, top-k masked; no top-p
    here), and the gap between the k-th and (k+1)-th largest z, where a
    rounding of z moves a token in or out of the top-k support."""
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


def _sampling_for(i):
    return SamplingParams(seed=100 + i, **SAMPLED)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("draw", ["greedy", "sampled"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_served_outputs_and_stats_match_reference(weights, mix, draw,
                                                       mode, monkeypatch):
    ref_cfg, jp, cfg, tp = weights
    ref_reqs, reqs = MIXES[mix](ref_server), MIXES[mix](server)
    if draw == "sampled":
        from repro.models.sampling import SamplingParams as RefParams
        for i, (r, rr) in enumerate(zip(reqs, ref_reqs)):
            r.sampling = _sampling_for(i)
            rr.sampling = RefParams(seed=100 + i, **SAMPLED)
    fp8 = MODES[mode]
    ref_srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False,
                                       spec_decode=K, **KW, **fp8)
    rec = {}
    _spy_reference(monkeypatch, ref_srv, rec)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.ChunkedServer(cfg, tp, device="cpu", spec_decode=K, **KW,
                               **fp8)
    stats = srv.serve(reqs)
    partings = []
    for i, (r, rr) in enumerate(zip(reqs, ref_reqs)):
        assert r.done and rr.done
        if r.output != rr.output:
            n = min(len(r.output), len(rr.output))
            j = next((i for i in range(n) if r.output[i] != rr.output[i]), n)
            call, lg = rec[(rr.rid, j)]
            partings.append((call, r.rid, j, lg, i))
    first = min((p[0] for p in partings), default=0)
    margin = MARGIN if mode == "bf16" else FP8_MARGIN
    for call, rid, j, lg, i in partings:
        if fp8 and call > first:
            continue
        if draw == "greedy":
            top = np.sort(lg)
            assert top[-1] - top[-2] <= margin, (mix, rid, j)
        else:
            pos = len(reqs[i].prompt) + j
            gaps = _draw_margins(lg, _sampling_for(i), pos)
            assert min(gaps) <= margin / SAMPLED["temperature"], \
                (mix, rid, j, gaps)
    if not partings:
        for key in EXACT_STATS:
            assert stats[key] == ref_stats[key], (key, stats[key],
                                                  ref_stats[key])
        for name in ("serving.spec.rollback_blocks", "serving.cow.resolves",
                     "serving.dispatches.verify"):
            assert (srv.metrics.counter_value(name)
                    == ref_srv.metrics.counter_value(name)), name
    assert stats["spec_steps"] > 0
    if mix == "repetitive" and draw == "greedy":
        assert stats["spec_accepted_tokens"] > 0     # the drafts hit
    print(f"{mix} {draw} {mode}: {len(partings)}/{len(reqs)} streams parted"
          f" (each within the margin); spec steps {stats['spec_steps']:g}, "
          f"acceptance {stats['spec_acceptance_rate']:.3f}, rollback "
          f"blocks {srv.metrics.counter_value('serving.spec.rollback_blocks')}")


# ----------------------------------------------------------------------
# within the port
# ----------------------------------------------------------------------

def _serve(cfg, tp, reqs, *, per_req=None, srv=None, **kw):
    srv = srv or server.ChunkedServer(cfg, tp, device="cpu",
                                      **{**KW, **kw})
    rs = server.clone_requests(reqs)
    if per_req is not None:
        for i, r in enumerate(rs):
            r.sampling = per_req(i)
    srv.serve(rs)
    assert all(r.done for r in rs)
    return [r.output for r in rs], srv


@pytest.mark.parametrize("mix", ["sharegpt", "repetitive"])
def test_spec_equals_k0_within_the_port(weights, mix):
    """Greedy K=3 equals K=0 bitwise; sampled K=3 equals sampled K=0
    given the seeds (each verify row draws with the key of its
    emission position)."""
    _, _, cfg, tp = weights
    reqs = MIXES[mix](server)
    sp = lambda i: SamplingParams(temperature=0.9, top_k=30,  # noqa: E731
                                  top_p=0.95, seed=200 + i)
    g0, _ = _serve(cfg, tp, reqs)
    g3, srv = _serve(cfg, tp, reqs, spec_decode=K)
    assert g3 == g0
    s0, _ = _serve(cfg, tp, reqs, per_req=sp)
    s3, _ = _serve(cfg, tp, reqs, per_req=sp, spec_decode=K)
    assert s3 == s0
    assert s0 != g0                          # really sampled


@pytest.mark.parametrize("k", [0, K])
def test_all_greedy_argmax_head_equals_the_sample_head(weights, monkeypatch,
                                                       k):
    """Every dispatch ends in the sample head, all-greedy ones too (one
    head, greedy by value, so a greedy/sampled flip changes no program);
    an argmax head in its place gives the same tokens bit for bit, and
    a sampled slot leaves the greedy slots' tokens as they were."""
    _, _, cfg, tp = weights
    reqs = MIXES["sysprompt"](server)
    calls = []
    orig = server.sampling.sample_tokens
    monkeypatch.setattr(server.sampling, "sample_tokens",
                        lambda *a: calls.append(1) or orig(*a))
    head, _ = _serve(cfg, tp, reqs, spec_decode=k)
    assert calls
    monkeypatch.setattr(
        server.sampling, "sample_tokens",
        lambda logits, *a: torch.argmax(logits, -1).to(torch.int32))
    argmax, _ = _serve(cfg, tp, reqs, spec_decode=k)
    assert argmax == head
    monkeypatch.setattr(server.sampling, "sample_tokens", orig)
    mixed, _ = _serve(cfg, tp, reqs, spec_decode=k, per_req=lambda i: (
        SamplingParams(temperature=0.8, seed=i) if i == 0 else None))
    assert mixed[1:] == head[1:]


def test_spec_sampled_distribution_matches_k0_ks(weights):
    """Disjoint seeds, >= 200 emitted tokens a side: K>0 and K=0 draw
    from one distribution (a seeded KS test cannot reject)."""
    _, _, cfg, tp = weights
    reqs = server.repetitive_requests(16, cfg.vocab_size, motif_len=4,
                                      reps=3, max_output=16, seed=6)
    k0, _ = _serve(cfg, tp, reqs, per_req=lambda i: SamplingParams(
        temperature=1.0, seed=i))
    k3, _ = _serve(cfg, tp, reqs, spec_decode=K,
                   per_req=lambda i: SamplingParams(temperature=1.0,
                                                    seed=1000 + i))
    a = np.concatenate([np.asarray(o) for o in k0])
    b = np.concatenate([np.asarray(o) for o in k3])
    assert len(a) >= 200 and len(b) >= 200
    d, pval = ks_two_sample(a, b)
    assert pval > 0.01, (d, pval)


def test_greedy_sampled_greedy_on_one_server_equals_fresh_servers(weights):
    _, _, cfg, tp = weights
    reqs = MIXES["sysprompt"](server)
    sp = lambda i: SamplingParams(temperature=0.8, top_k=40,  # noqa: E731
                                  top_p=0.95, seed=i)
    srv = server.ChunkedServer(cfg, tp, device="cpu", spec_decode=K, **KW)
    waves = [_serve(cfg, tp, reqs, per_req=p, srv=srv)[0]
             for p in (None, sp, None)]
    fresh = [_serve(cfg, tp, reqs, per_req=p, spec_decode=K)[0]
             for p in (None, sp, None)]
    assert waves == fresh
    assert waves[0] == waves[2] != waves[1]


def test_server_sampling_default_and_per_request(weights):
    """`sampling=` is the server's default; a request's own params win."""
    _, _, cfg, tp = weights
    reqs = MIXES["sharegpt"](server)
    sp = SamplingParams(temperature=0.7, seed=11)
    a, _ = _serve(cfg, tp, reqs, sampling=sp)
    b, _ = _serve(cfg, tp, reqs, per_req=lambda i: sp)
    c, _ = _serve(cfg, tp, reqs, sampling=sp,
                  per_req=lambda i: SamplingParams())
    g, _ = _serve(cfg, tp, reqs)
    assert a == b and c == g and a != g
    with pytest.raises(ValueError):
        server.ChunkedServer(cfg, tp, device="cpu", spec_decode=-1, **KW)


def test_rollback_across_a_block_boundary(weights):
    """A verify window crossing a block boundary: the rejected rows'
    blocks return to the pool, reservations are restored, and the
    outputs equal K=0 (no stale K/V is read)."""
    _, _, cfg, tp = weights
    reqs = server.sharegpt_like_requests(6, cfg.vocab_size, max_input=16,
                                         max_output=20, seed=8)
    g0, _ = _serve(cfg, tp, reqs, block_size=4)
    g3, srv = _serve(cfg, tp, reqs, block_size=4, spec_decode=K)
    assert g3 == g0
    assert srv.metrics.counter_value("serving.spec.rollback_blocks") > 0
    assert srv._reserved_total == 0 and srv.pool.num_free() + (
        srv.prefix_cache.evictable_blocks()) == srv.num_blocks


# ----------------------------------------------------------------------
# the serving CLI
# ----------------------------------------------------------------------

def test_cli_spec_decode_repetitive(capsys):
    argv = ["--device", "cpu", "--spec-decode", "3", "--workload",
            "repetitive", "--requests", "6", "--slots", "3",
            "--max-input", "16", "--max-output", "12"]
    stats = serve_cli.main(argv)
    out = capsys.readouterr().out
    m = re.search(r"spec-decode: K=(\d+) accepted=(\d+)/(\d+) drafts "
                  r"\(rate=([\d.]+)\), ([\d.]+) tokens/step over (\d+) "
                  r"verify dispatches", out)
    assert m, out
    assert int(m.group(1)) == 3 == stats["spec_k"]
    assert int(m.group(2)) == stats["spec_accepted_tokens"]
    assert int(m.group(3)) == stats["spec_drafted_tokens"]
    assert int(m.group(6)) == stats["spec_steps"] > 0
    assert float(m.group(4)) == round(stats["spec_acceptance_rate"], 2)
    # the same run on a server built directly gives the same stats
    cfg = reduced_config("yi-6b")
    from repro_torch.models import api
    params = api.init(cfg, 0, device="cpu")
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=36,
                               chunk=16, span=8, block_size=16,
                               spec_decode=3, device="cpu")
    reqs = server.repetitive_requests(6, cfg.vocab_size, num_motifs=2,
                                      motif_len=4, reps=4, max_output=12,
                                      seed=0)
    direct = srv.serve(reqs)
    for key in ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
                "tokens", "decode_spans"):
        assert direct[key] == stats[key], key
