"""One program per work unit, and the paged plan past the held scores.

* `ChunkedServer.compile_counts()` of the port equals the reference's,
  key for key, on the same traffic (the reference counts ``jax.jit``
  programs; the port counts the operand signatures of its work units,
  which on the card are its captured CUDA graphs): distinct prompt
  lengths and then new ones (`tests/test_serving.py`), greedy -> sampled
  -> greedy -> new-seed sampled with spec decode
  (`tests/test_sampling.py`), a copy-on-write divergence
  (`tests/test_prefix_cache.py`) and ``spec_decode=0`` (no
  ``verify_step`` key, `tests/test_spec_decode.py`).  The served
  streams' lengths are the reference's on the same traffic (tokens and
  host state are held in tests/test_torch_server.py and
  tests/test_torch_spec.py).
* A `WorkUnit` takes one operand signature: another raises, and its
  static buffers are the same tensors from call to call.
* The paged plan rule: at or under the longest table whose scores a
  cluster holds (the context cap before recomputed scores existed), the
  plan is the one the rule chose before them (the table below), for
  every q dtype and head_dim the kernel takes; past it, the plan that
  recomputes the scores.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.runtime import server as ref_server
from repro_torch.configs import reduced_config
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import convert
from repro_torch.runtime import server
from repro_torch.runtime.graphs import WorkUnit


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config("yi-6b")
    cfg = reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


def _pair(weights, **kw):
    """The reference's server (gather path) and the port's, alike."""
    ref_cfg, jp, cfg, tp = weights
    return (ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **kw),
            server.ChunkedServer(cfg, tp, device="cpu", **kw))


def _serve_both(ref_srv, srv, make, per_req=None):
    """Serve the same requests on both; returns the port's outputs and
    both servers' compile counts."""
    outs = []
    for mod, s in ((ref_server, ref_srv), (server, srv)):
        reqs = make(mod)
        for i, r in enumerate(reqs):
            if per_req is not None:
                r.sampling = per_req(mod, i)
        s.serve(reqs)
        assert all(r.done for r in reqs)
        outs.append([len(r.output) for r in reqs])
    assert outs[0] == outs[1]
    return ref_srv.compile_counts(), srv.compile_counts()


def test_compile_counts_independent_of_prompt_lengths(weights):
    """8 prompts of 8 distinct lengths, then 8 more: one program a unit,
    none added by the second batch, as the reference counts."""
    ref_srv, srv = _pair(weights, batch_slots=4, max_len=64, chunk=8,
                         span=4)
    assert srv.compile_counts() == ref_srv.compile_counts() == {
        "chunk_step": 0, "decode_span": 0, "cow_copy": 0}

    def batch(lengths, rid0):
        def make(mod):
            rng = np.random.default_rng(rid0)
            return [mod.Request(rid=rid0 + i, prompt=rng.integers(
                0, 256, n).astype(np.int32), max_new=4)
                for i, n in enumerate(lengths)]
        return make

    want, got = _serve_both(ref_srv, srv, batch(range(3, 11), 0))
    assert got == want
    assert sum(got.values()) <= 3
    want2, got2 = _serve_both(ref_srv, srv, batch(range(11, 19), 100))
    assert got2 == want2 == got


def test_greedy_sampled_flips_add_zero_programs(weights):
    """One spec server, greedy -> sampled -> greedy -> new-seed sampled:
    each wave's counts equal the reference's, and the three step
    programs are those of the first wave (one sample head, greedy by
    value).  The copy-on-write copy joins in a later wave on both sides,
    when prompts meet their earlier runs in the prefix cache, as the
    reference's own test allows."""
    ref_srv, srv = _pair(weights, batch_slots=3, max_len=64, chunk=8,
                         span=4, block_size=8, spec_decode=3)

    def make(mod):
        return mod.sharegpt_like_requests(6, 256, max_input=16,
                                          max_output=8, seed=3)

    def sampled(temperature, top_k=0, top_p=1.0, seed0=0):
        return lambda mod, i: mod.SamplingParams(
            temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed0 + i)

    steps = ("chunk_step", "decode_span", "verify_step")
    want, got = _serve_both(ref_srv, srv, make)
    assert got == want and got["verify_step"] == 1
    first = {k: got[k] for k in steps}
    for per_req in (sampled(0.8, 40, 0.95), None, sampled(1.2, seed0=77)):
        want, got = _serve_both(ref_srv, srv, make, per_req)
        assert got == want
        assert {k: got[k] for k in steps} == first


def test_cow_copy_compiles_once(weights):
    """Two requests share a prefix and diverge mid-block: the second
    copies on write, and the copy's program counts once on both."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, 22).astype(np.int32)
    div = base.copy()
    div[20:] = (div[20:] + 1) % 256
    ref_srv, srv = _pair(weights, batch_slots=2, max_len=64, chunk=8,
                         span=4, block_size=8)

    def reqs(*prompts):
        return lambda mod: [mod.Request(rid=i, prompt=p.copy(), max_new=6)
                            for i, p in enumerate(prompts)]

    _serve_both(ref_srv, srv, reqs(base))
    assert srv.compile_counts()["cow_copy"] == 0
    want, got = _serve_both(ref_srv, srv, reqs(div, base))
    assert srv.metrics.counter_value("serving.cow.resolves") >= 1
    assert got == want and got["cow_copy"] == 1


def test_spec_off_has_no_verify_program(weights):
    ref_srv, srv = _pair(weights, batch_slots=2, max_len=32, chunk=4,
                         span=2)
    want, got = _serve_both(ref_srv, srv, lambda mod: (
        mod.sharegpt_like_requests(2, 256, max_input=8, max_output=4,
                                   seed=1)))
    assert "verify_step" not in got
    assert got == want


def test_unit_takes_one_signature_and_keeps_its_buffers():
    """A unit fixes its operand signature at its first call; another
    shape or dtype raises (no second program), and its static inputs
    and outputs are the same tensors at every call."""
    seen = []

    def body(x, y):
        seen.append((x, y))
        return (x * 2, y + 1)

    unit = WorkUnit("toy", body, "cpu")
    assert unit.programs == 0
    a = unit.run(np.arange(3, dtype=np.int32), np.ones(2, np.float32))
    b = unit.run(np.arange(3, 6, dtype=np.int32), np.zeros(2, np.float32))
    assert unit.programs == 1 and unit.calls == 2 and unit.captures == 0
    assert all(x is y for x, y in zip(a, b))
    assert all(x is y for x, y in zip(*seen))
    assert b[0].tolist() == [6, 8, 10] and b[1].tolist() == [1.0, 1.0]
    for bad in ((np.arange(4, dtype=np.int32), np.ones(2, np.float32)),
                (np.arange(3, dtype=np.int64), np.ones(2, np.float32)),
                (np.arange(3, dtype=np.int32),)):
        with pytest.raises(ValueError, match="never captures twice"):
            unit.run(*bad)
    assert unit.programs == 1 and unit.calls == 2


def test_server_unit_refuses_another_shape(weights):
    """A server's chunk unit, once used, refuses a chunk of another
    width: the program count stays 1."""
    _, _, cfg, tp = weights
    srv = server.ChunkedServer(cfg, tp, device="cpu", batch_slots=2,
                               max_len=32, chunk=4, span=2)
    srv.serve(server.sharegpt_like_requests(2, 256, max_input=8,
                                            max_output=4, seed=1))
    unit = srv._units["chunk_step"]
    B, C = srv.B, srv.chunk
    ops = [np.zeros((B, C + 1), np.int32)] + [np.zeros(B, np.int32)] * 2 + [
        np.zeros(B, bool)] * 2 + [np.zeros(B, np.int32)] + list(
        srv._samp_mirrors()) + [srv.block_table]
    with pytest.raises(ValueError, match="never captures twice"):
        unit.run(*ops)
    assert srv.compile_counts()["chunk_step"] == 1


def test_device_launch_counter_reads_only_a_cuda_device():
    """The paged kernel's own launch counter lives on the card: asked
    of the CPU, it raises rather than answer from the host's counts."""
    with pytest.raises(ValueError, match="CUDA device"):
        pk.device_launches("cpu")


# ----------------------------------------------------------------------
# the plan past the held scores (the held plans' table at and under the
# cap)
# ----------------------------------------------------------------------

# (B, KH, G, C) of each case; T is 272, 32768 and the cap
PLAN_SHAPES = [(8, 4, 8, 1), (8, 4, 8, 16), (8, 4, 8, 5), (2, 4, 8, 1),
               (1, 4, 8, 16), (8, 32, 1, 16)]
# the longest table whose scores a cluster holds: the cap the kernels
# had before they recomputed scores
HELD_CAP = {
    "float32": {16: 105216, 32: 96768, 64: 79872, 80: 71424, 128: 46080},
    "bfloat16": {16: 109312, 32: 105216, 64: 96768, 80: 92416,
                 128: 79872},
}
# the held plans, splits x rows, shape by shape, T = 272, 32768, cap
HELD_PLANS = {
    ("float32", 16): "2x8 16x8 16x8 2x64 16x16 16x8 2x24 16x24 16x8 "
                     "2x8 8x8 16x8 2x8 16x16 16x8 1x16 16x16 16x8",
    ("float32", 128): "2x8 16x8 16x8 2x64 16x8 16x8 2x24 16x8 16x8 "
                      "2x8 16x8 16x8 2x8 16x8 16x8 1x16 16x8 16x8",
    ("bfloat16", 16): "2x8 16x8 16x8 2x64 16x16 16x8 2x24 16x24 16x8 "
                      "2x8 8x8 16x8 2x8 16x16 16x8 1x16 16x16 16x8",
    ("bfloat16", 32): "2x8 16x8 16x8 2x64 16x16 16x8 2x24 16x24 16x8 "
                      "2x8 8x8 16x8 2x8 16x16 16x8 1x16 16x16 16x8",
}
_REST = ("2x8 16x8 16x8 2x64 16x16 16x8 2x24 16x16 16x8 "
         "2x8 8x8 16x8 2x8 16x16 16x8 1x16 16x16 16x8")
for _key in [(d, hd) for d in HELD_CAP for hd in pk.HEAD_DIMS]:
    HELD_PLANS.setdefault(_key, _REST)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", pk.HEAD_DIMS)
def test_plans_unchanged_under_the_cap_recompute_past_it(dtype, hd):
    dt = getattr(torch, dtype)
    cap = HELD_CAP[dtype][hd]
    assert pk.held_scores_context(dt, hd) == cap
    want = iter(HELD_PLANS[(dtype, hd)].split())
    for B, KH, G, C in PLAN_SHAPES:
        for T in (272, 32768, cap):
            p = pk.plan(dt, hd, B, KH, G, C, T)
            S, R = map(int, next(want).split("x"))
            assert (p.splits, p.rows, p.recompute) == (S, R, False), (
                B, KH, G, C, T)
            assert p.split_len == pk._round_up(-(-T // S), 16)
            assert p.smem == pk.smem_bytes(dt, hd, R, p.split_len, S)
        for T in (cap + 1, 131072, 524288):
            p = pk.plan(dt, hd, B, KH, G, C, T)
            assert p.recompute and p.body == pk.body(dt)
            assert p.smem == pk.smem_bytes(dt, hd, p.rows, p.split_len,
                                           p.splits, True) <= pk.SMEM_LIMIT
            assert p.splits * p.split_len >= T
            assert p.groups == -(-C * G // p.rows)
            # the scores region is one tile's, whatever T
            assert p.smem < pk.smem_bytes(dt, hd, p.rows, p.split_len,
                                          p.splits)
    # forced: the recompute plan at a short table too (for the card
    # tests), with the same splits and rows the held plan would take
    held = pk.plan(dt, hd, 8, 4, 8, 16, 272)
    forced = pk.plan(dt, hd, 8, 4, 8, 16, 272, recompute=True)
    assert forced.recompute and not held.recompute
