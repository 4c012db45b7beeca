"""The contiguous KV layout (``paged=False``) and the slot baseline, port
vs reference, on the CPU.

* `attention.update_cache` writes a window at a scalar or per-slot
  `pos` exactly as the reference's (``dynamic_update_slice``, whose
  start clamps to T - C), and `init_kv_cache` lays out the same leaves;
* the serving steps on a contiguous cache (`chunk_step`, `decode_step`
  with per-slot and lockstep positions, `verify_step`), teacher-forced
  with the reference's weights: logits within test_torch_transformer.py's
  tolerance (LOGIT_STEPS bf16 steps of the largest logit), argmax equal
  wherever the reference's top-2 margin is clear of it, caches within
  the same tolerance;
* `ChunkedServer(paged=False)` against the reference's, K=0 and K=4:
  token streams held as test_torch_server.py holds the paged ones (a
  stream may part only where the reference's own top-2 margin is
  within MARGIN), host counts, stats keys and `compile_counts()`
  exactly equal;
* inside the port, paged and contiguous servers give identical tokens
  (the reference's tests/test_serving.py invariant), and spec K=4
  equals K=0 on the contiguous layout; a window that does not fit the
  chunk headroom is refused, as in the reference;
* `SlotServer` against the reference's: streams (same margin rule),
  `compile_counts()` and stats keys; its streams equal the port's
  ChunkedServer's; requests that stop at their first token leave the
  rest of the queue served.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer
from repro.runtime import server as ref_server
from repro_torch.configs import reduced_config
from repro_torch.models import api, attention, convert, transformer
from repro_torch.runtime import server

# four bf16 steps at |logit| < 4 (test_torch_server.py's MARGIN)
MARGIN = 0.0625
LOGIT_STEPS = 4          # test_torch_transformer.py's tolerance

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4)


def _tol(ref) -> float:
    return LOGIT_STEPS * 2.0 ** -7 * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config("yi-6b")
    cfg = reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


# ----------------------------------------------------------------------
# the cache write
# ----------------------------------------------------------------------

T_CACHE = 12

UPDATE_CASES = {
    # name: (pos, C); pos a scalar or one entry a slot (B = 3)
    "scalar_decode": (5, 1),
    "scalar_chunk": (2, 4),
    "per_slot_decode": ([0, 7, 11], 1),
    "per_slot_chunk": ([0, 3, 8], 4),
    "scalar_clamps": (T_CACHE - 2, 4),
    "per_slot_clamps": ([T_CACHE, T_CACHE - 3, 1], 5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_cache_matches_reference(case, dtype):
    pos, C = UPDATE_CASES[case]
    B, KH, hd = 3, 2, 8
    rng = np.random.default_rng(len(case))
    ck, cv = (rng.standard_normal((B, T_CACHE, KH, hd)).astype(np.float32)
              for _ in range(2))
    k1, v1 = (rng.standard_normal((B, C, KH, hd)).astype(np.float32)
              for _ in range(2))
    jd = getattr(jax.numpy, dtype)
    jk, jv = ref_attention.update_cache(
        jax.numpy.asarray(ck, jd), jax.numpy.asarray(cv, jd), k1, v1,
        jax.numpy.asarray(pos, jax.numpy.int32))
    td = getattr(torch, dtype)
    tk, tv = torch.from_numpy(ck).to(td), torch.from_numpy(cv).to(td)
    ok, ov = attention.update_cache(tk, tv, torch.from_numpy(k1),
                                    torch.from_numpy(v1),
                                    torch.tensor(pos, dtype=torch.int32))
    assert ok is tk and ov is tv                    # in place
    for a, b in ((jk, tk), (jv, tv)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_init_kv_cache_matches_reference(weights):
    ref_cfg, _, cfg, _ = weights
    ref = ref_attention.init_kv_cache(ref_cfg, 3, 20, layers=2)
    port = attention.init_kv_cache(cfg, 3, 20, layers=2, device="cpu")
    assert set(ref) == set(port) == {"k", "v", "length"}
    for k in ref:
        assert tuple(ref[k].shape) == tuple(port[k].shape), k
        assert str(ref[k].dtype) == str(port[k].dtype).split(".")[-1], k
        assert not port[k].any()
    ref_c = ref_transformer.init_cache(ref_cfg, 3, 20)
    port_c = api.init_cache(cfg, 3, 20, paged=False, device="cpu")
    assert set(ref_c) == set(port_c) == {"k", "v"}
    assert all(tuple(ref_c[k].shape) == tuple(port_c[k].shape)
               for k in ref_c)


# ----------------------------------------------------------------------
# the serving steps on a contiguous cache
# ----------------------------------------------------------------------

def _configs(kv_heads):
    return (dataclasses.replace(ref_reduced_config("yi-6b"),
                                num_kv_heads=kv_heads),
            dataclasses.replace(reduced_config("yi-6b"),
                                num_kv_heads=kv_heads))


def _held(what, jl, tl):
    a = np.asarray(jl, np.float32)
    b = tl.float().numpy()
    tol = _tol(a)
    assert np.abs(a - b).max() <= tol, (what, np.abs(a - b).max(), tol)
    top = np.sort(a, axis=-1)
    clear = top[..., -1] - top[..., -2] > 2 * tol
    assert (a.argmax(-1) == b.argmax(-1))[clear].all(), what
    return a


@pytest.mark.parametrize("kv_heads", [4, 2])         # G = 1, G = 2
def test_teacher_forced_contiguous_steps(kv_heads):
    """Two chunk steps, three decode steps and a verify step on a
    contiguous cache of both packages, each fed the reference's argmax:
    logits and caches within LOGIT_STEPS, the verify step's argmax
    equal where clear (its logits are the chunk forward read out at
    every row)."""
    ref_cfg, cfg = _configs(kv_heads)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    B, C, T = 3, 8, 40
    jc = ref_api.init_cache(ref_cfg, B, T)
    tc = api.init_cache(cfg, B, T, paged=False, device="cpu")
    chunk = jax.jit(functools.partial(ref_api.chunk_step, ref_cfg))
    decode = jax.jit(functools.partial(ref_api.decode_step, ref_cfg))
    t = torch.from_numpy
    rng = np.random.default_rng(kv_heads)
    pos = np.zeros(B, np.int32)
    for step, n_tok in enumerate(([8, 5, 3], [8, 2, 0])):
        n_tok = np.asarray(n_tok, np.int32)
        toks = rng.integers(0, ref_cfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = chunk(jp, jc, toks, pos, n_tok)
        tl, _ = api.chunk_step(cfg, tp, tc, t(toks), t(pos), t(n_tok))
        a = _held(f"chunk {step}", jl, tl)
        pos = pos + n_tok
    for step in range(3):
        tok = a.argmax(-1).astype(np.int32)
        jl, jc = decode(jp, jc, tok, pos)
        tl, _ = api.decode_step(cfg, tp, tc, t(tok), t(pos))
        a = _held(f"decode {step}", jl, tl)
        pos = pos + 1
    window = np.concatenate([a.argmax(-1).astype(np.int32)[:, None],
                             rng.integers(0, ref_cfg.vocab_size, (B, 4))],
                            axis=1).astype(np.int32)
    jx, jc = ref_transformer._chunk_fwd(ref_cfg, jp, jc, window, pos, None)
    jl = ref_transformer.logits_fn(ref_cfg, jp, jx)
    tx = transformer._chunk_fwd(cfg, tp, tc, t(window), t(pos), None,
                                kernel=False, quant=None)
    _held("verify logits", jl, transformer.logits_fn(cfg, tp, tx))
    # the public verify step over fresh copies gives the same argmax
    tc2 = {k: v.clone() for k, v in tc.items()}
    preds, _ = api.verify_step(cfg, tp, tc2, t(window), t(pos))
    assert torch.equal(preds, transformer.logits_fn(cfg, tp, tx).argmax(
        -1).to(torch.int32))
    for k in ("k", "v"):
        a = np.asarray(jc[k], np.float32)
        assert np.abs(a - tc[k].float().numpy()).max() <= _tol(a), k


@pytest.mark.parametrize("step", ["decode", "chunk", "verify"])
def test_kernel_without_a_block_table_raises(weights, step):
    """The kernels read the paged pool through a block table: asking for
    them on a contiguous cache raises (the reference refuses kernel=
    without the paged layout) instead of running the plain attention."""
    _, _, cfg, tp = weights
    B, C = 2, 3
    cache = api.init_cache(cfg, B, 16, paged=False, device="cpu")
    pos = torch.zeros(B, dtype=torch.int32)
    tok = torch.zeros(B, dtype=torch.int32)
    window = torch.zeros(B, C, dtype=torch.int32)
    n_tok = torch.full((B,), C, dtype=torch.int32)
    calls = {
        "decode": lambda: api.decode_step(cfg, tp, cache, tok, pos,
                                          kernel=True),
        "chunk": lambda: api.chunk_step(cfg, tp, cache, window, pos, n_tok,
                                        kernel=True),
        "verify": lambda: api.verify_step(cfg, tp, cache, window, pos,
                                          kernel=True)}
    with pytest.raises(ValueError, match="block_table"):
        calls[step]()
    assert not cache["k"].any() and not cache["v"].any()


def test_lockstep_decode_with_scalar_pos():
    """decode_step with one scalar position for every slot (the
    reference's lockstep decode) from an empty contiguous cache."""
    ref_cfg, cfg = _configs(2)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(1))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    B, T = 2, 8
    jc = ref_api.init_cache(ref_cfg, B, T)
    tc = api.init_cache(cfg, B, T, paged=False, device="cpu")
    tok = np.asarray([3, 17], np.int32)
    for step in range(3):
        jl, jc = ref_api.decode_step(ref_cfg, jp, jc, tok,
                                     jax.numpy.int32(step))
        tl, _ = api.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                                torch.tensor(step, dtype=torch.int32))
        a = _held(f"lockstep decode {step}", jl, tl)
        tok = a.argmax(-1).astype(np.int32)


# ----------------------------------------------------------------------
# ChunkedServer(paged=False) and SlotServer against the reference
# ----------------------------------------------------------------------

def _spy(monkeypatch, ref_srv, rec):
    """Record the reference server's logits at each sample-head call
    under (rid, output index emitted there), as test_torch_server.py
    does."""
    orig = ref_server.sampling.sample_tokens

    def record(lg, ix):
        # a verify call draws every row of its window: a later call's
        # record of a position is the one that emitted it
        ix = np.asarray(ix).reshape(len(ref_srv.slot_req), -1)
        lg = np.asarray(lg, np.float32).reshape(ix.shape + (-1,))
        for s, r in enumerate(ref_srv.slot_req):
            if r is not None:
                for j in range(ix.shape[1]):
                    rec[(r.rid, int(ix[s, j]) - len(r.prompt))] = lg[s, j]

    def spy(logits, temp, top_k, top_p, seed, index):
        jax.debug.callback(record, logits, index)
        return orig(logits, temp, top_k, top_p, seed, index)

    monkeypatch.setattr(ref_server.sampling, "sample_tokens", spy)


def _hold_streams(reqs, ref_reqs, rec, label):
    """Equal lengths; a stream may part only where the reference's
    recorded logits have a top-2 margin within MARGIN.  Returns the
    number of streams that parted."""
    parted = 0
    for r, rr in zip(reqs, ref_reqs):
        assert r.done and rr.done
        assert len(r.output) == len(rr.output), (label, r.rid)
        if r.output == rr.output:
            continue
        parted += 1
        j = next(i for i, (a, b) in enumerate(zip(r.output, rr.output))
                 if a != b)
        lg = rec[(rr.rid, j)]
        assert int(lg.argmax()) == rr.output[j]
        top = np.sort(lg)
        assert top[-1] - top[-2] <= MARGIN, (label, r.rid, j)
        assert lg.max() - lg[r.output[j]] <= MARGIN, (label, r.rid, j)
    print(f"{label}: {parted}/{len(reqs)} streams parted")
    return parted


EXACT = ("chunk_steps", "decode_spans", "decode_steps", "prefill_tokens",
         "decode_tokens", "tokens", "requests", "compiled_programs", "tp")


@pytest.mark.parametrize("spec", [0, 4])
def test_contiguous_server_matches_reference(weights, spec, monkeypatch):
    ref_cfg, jp, cfg, tp = weights
    make = lambda mod: mod.sharegpt_like_requests(        # noqa: E731
        6, 256, max_input=16, max_output=8, seed=3)
    ref_reqs, reqs = make(ref_server), make(server)
    ref_srv = ref_server.ChunkedServer(ref_cfg, jp, paged=False,
                                       spec_decode=spec, **KW)
    rec = {}
    _spy(monkeypatch, ref_srv, rec)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.ChunkedServer(cfg, tp, paged=False, spec_decode=spec,
                               device="cpu", **KW)
    stats = srv.serve(reqs)
    assert set(stats) == set(ref_stats)
    assert "kv_tokens_contiguous" not in stats
    for key in EXACT + (("spec_steps",) if spec else ()):
        assert stats[key] == ref_stats[key], (key, stats[key],
                                              ref_stats[key])
    assert srv.compile_counts() == ref_srv.compile_counts()
    assert "cow_copy" not in srv.compile_counts()
    _hold_streams(reqs, ref_reqs, rec, f"contiguous K={spec}")


def test_paged_equals_contiguous_in_the_port(weights):
    """The reference's invariant (tests/test_serving.py): paged and
    contiguous servers give identical greedy tokens, each with its
    O(1) programs; and the paged pool's capacity undercuts the
    contiguous layout's + chunk headroom."""
    _, _, cfg, tp = weights
    reqs = server.sharegpt_like_requests(8, cfg.vocab_size, max_input=16,
                                         max_output=8, seed=11)
    a, b = server.clone_requests(reqs), server.clone_requests(reqs)
    contiguous = server.ChunkedServer(cfg, tp, paged=False, device="cpu",
                                      **KW)
    paged = server.ChunkedServer(cfg, tp, paged=True, block_size=8,
                                 device="cpu", **KW)
    contiguous.serve(a)
    stats = paged.serve(b)
    assert all(r.done for r in a) and all(r.done for r in b)
    assert [r.output for r in a] == [r.output for r in b]
    assert contiguous.compile_counts() == {"chunk_step": 1,
                                           "decode_span": 1}
    assert sum(paged.compile_counts().values()) <= 3
    assert stats["kv_tokens_capacity"] < stats["kv_tokens_contiguous"]
    assert contiguous.cache["k"].shape[2] == KW["max_len"] + KW["chunk"]


def test_spec_on_the_contiguous_layout(weights):
    """K=4 equals K=0 on the contiguous layout (rejected rows land in
    the chunk headroom and are overwritten before they are read), and a
    window that does not fit the headroom is refused, by the port as by
    the reference."""
    ref_cfg, jp, cfg, tp = weights
    reqs = server.sharegpt_like_requests(4, cfg.vocab_size, max_input=12,
                                         max_output=8, seed=8)
    a, b = server.clone_requests(reqs), server.clone_requests(reqs)
    kw = dict(batch_slots=2, max_len=64, chunk=8, span=4, paged=False,
              device="cpu")
    server.ChunkedServer(cfg, tp, **kw).serve(a)
    srv = server.ChunkedServer(cfg, tp, spec_decode=4, **kw)
    stats = srv.serve(b)
    assert [r.output for r in a] == [r.output for r in b]
    assert stats["spec_steps"] > 0
    assert srv.compile_counts() == {"chunk_step": 1, "decode_span": 0,
                                    "verify_step": 1}
    with pytest.raises(ValueError, match="headroom"):
        server.ChunkedServer(cfg, tp, spec_decode=8, **kw)
    with pytest.raises(AssertionError, match="headroom"):
        ref_server.ChunkedServer(ref_cfg, jp, batch_slots=2, max_len=64,
                                 chunk=8, span=4, paged=False,
                                 spec_decode=8)


def test_contiguous_tracer_meta_has_no_pool(weights):
    from repro_torch.obs import Tracer
    _, _, cfg, tp = weights
    tracer = Tracer()
    srv = server.ChunkedServer(cfg, tp, paged=False, device="cpu",
                               tracer=tracer, **KW)
    srv.serve(server.sharegpt_like_requests(3, cfg.vocab_size,
                                            max_input=12, max_output=6))
    assert tracer.meta["paged"] is False
    assert not {"block_size", "max_blocks", "num_blocks",
                "kv_read_mode"} & set(tracer.meta)
    assert all(r.ttft_s is not None for r in tracer.request_records())


SLOT_KW = dict(batch_slots=3, max_len=48)


def test_slot_server_matches_reference(weights, monkeypatch):
    """SlotServer: streams against the reference's (its argmax is read
    on the host; a parting is held at the logits the reference's
    decode program returned there), compile_counts() (one decode
    program, one prefill program a distinct prompt length), stats keys;
    its streams equal the port's ChunkedServer's."""
    ref_cfg, jp, cfg, tp = weights
    make = lambda mod: mod.sharegpt_like_requests(        # noqa: E731
        5, 256, max_input=8, max_output=6, seed=2)
    ref_reqs, reqs = make(ref_server), make(server)
    ref_srv = ref_server.SlotServer(ref_cfg, jp, **SLOT_KW)
    rec = {}
    orig_admit, orig_decode = ref_srv.admit, ref_srv._decode

    def admit(req, slot):
        lg = orig_admit(req, slot)
        rec[(req.rid, 0)] = np.asarray(lg, np.float32)
        return lg

    def decode(p, c, t, pos):
        lg, c = orig_decode(p, c, t, pos)
        for s, r in enumerate(ref_srv.slot_req):
            if r is not None:
                rec[(r.rid, len(r.output))] = np.asarray(lg[s], np.float32)
        return lg, c

    monkeypatch.setattr(ref_srv, "admit", admit)
    monkeypatch.setattr(ref_srv, "_decode", decode)
    ref_stats = ref_srv.serve(ref_reqs)
    srv = server.SlotServer(cfg, tp, device="cpu", **SLOT_KW)
    stats = srv.serve(reqs)
    assert set(stats) == set(ref_stats)
    assert stats["tokens"] == ref_stats["tokens"]
    counts = srv.compile_counts()
    monkeypatch.undo()
    assert counts == ref_srv.compile_counts()
    assert counts["prefill_one"] == len({len(r.prompt) for r in reqs})
    _hold_streams(reqs, ref_reqs, rec, "slot server")
    chunked = server.clone_requests(reqs)
    server.ChunkedServer(cfg, tp, batch_slots=3, max_len=48, chunk=8,
                         span=4, device="cpu").serve(chunked)
    assert [r.output for r in chunked] == [r.output for r in reqs]


def test_slot_server_first_token_stops_do_not_drop_the_queue(weights):
    """max_new=1 requests stop on their prefill token; admission goes on
    (a `break` would drop the rest of the queue), and an EOS stop is
    ChunkedServer's rule."""
    _, _, cfg, tp = weights
    reqs = server.sharegpt_like_requests(5, cfg.vocab_size, max_input=8,
                                         max_output=6, seed=4)
    ones = server.clone_requests(reqs)
    for r in ones:
        r.max_new = 1
    srv = server.SlotServer(cfg, tp, batch_slots=2, max_len=32,
                            device="cpu")
    stats = srv.serve(ones)
    assert all(r.done and len(r.output) == 1 for r in ones)
    assert stats["requests"] == 5.0
    assert srv.compile_counts()["decode_step"] == 0
    base = server.clone_requests(reqs)
    server.SlotServer(cfg, tp, batch_slots=2, max_len=32,
                      device="cpu").serve(base)
    eos = base[0].output[2]
    cut = server.clone_requests(reqs)
    server.SlotServer(cfg, tp, batch_slots=2, max_len=32, eos_id=eos,
                      device="cpu").serve(cut)
    for r, b in zip(cut, base):
        n = b.output.index(eos) + 1 if eos in b.output else len(b.output)
        assert r.output == b.output[:n]
