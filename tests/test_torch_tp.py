"""Tensor-parallel serving of the port (``ChunkedServer(mesh=...)``) on a
spread CPU mesh, against the reference's tp=1 and the port's tp=1.

The setting is the reference's ``tests/test_tp_serving.py``: reduced
yi-6b (4 heads, 4 KV heads, d_ff 128), its KW (3 slots, max_len 64,
chunk 8, span 4, paged, block 8, prefix cache, spec decode K=2), the
ShareGPT / system-prompt / repetitive mixes served in turn on one
server, weights from the reference's ``api.init(PRNGKey(0))`` bridged
with ``convert.from_reference``.  The reference holds its tp=2/4
streams equal to its tp=1 streams, so the port's tp=2/4 streams are
held to the reference's tp=1 streams, by the bar of
tests/test_torch_server.py (identical, or a stream parts at a step
where the reference's top-2 margin is within MARGIN; sampled draws
within the margin of tests/test_torch_spec.py), and to the port's own
tp=1 streams exactly.  The mesh lays its 2 or 4 positions on the CPU
(``make_tp_mesh(tp, spread="cpu")``); each position holds its own
shards and pools.

Also: one chunk step's and one verify step's logits at tp=2/4 bitwise
the tp=1 logits (the shards' grouped float32 partials gathered in shard
order and summed by the tp=1 fixed tree); host-side state (block
tables, refcounts, the radix tree, the stats) exactly equal across tp;
the tight pool's stalls; KV bytes per position; one program per unit;
and the constructor's refusals.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.runtime import server as ref_server
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import api, convert
from repro_torch.models.sampling import SamplingParams
from repro_torch.runtime import server
from repro_torch.sharding.axes import Mesh

KW = dict(batch_slots=3, max_len=64, chunk=8, span=4, paged=True,
          block_size=8, prefix_cache=True, spec_decode=2)
# four bf16 steps at |logit| < 4 (tests/test_torch_server.py)
MARGIN = 0.0625
SAMPLED = dict(temperature=0.8, top_k=8)
TPS = (2, 4)


def _mixes(mod):
    return {
        "sharegpt": mod.sharegpt_like_requests(
            6, 256, max_input=16, max_output=8, seed=3),
        "sysprompt": mod.sysprompt_sharegpt_requests(
            6, 256, num_templates=2, template_len=12, max_input=20,
            max_output=6, seed=4),
        "repetitive": mod.repetitive_requests(
            4, 256, motif_len=4, reps=3, max_output=10, seed=5),
    }


MIX_NAMES = tuple(_mixes(server))


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config("yi-6b")
    cfg = reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return ref_cfg, jp, cfg, params


def _record(srv, rec, logits, index) -> None:
    """The reference's logits by (rid, output index drawn at `index`)."""
    logits, index = np.asarray(logits, np.float32), np.asarray(index)
    if index.ndim == 1:
        logits, index = logits[:, None], index[:, None]
    for s, r in enumerate(srv.slot_req):
        if r is not None:
            for j in range(index.shape[1]):
                rec[(r.rid, int(index[s, j]) - len(r.prompt))] = logits[s, j]


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's tp=1 streams (the three mixes in turn on one
    server, then a sampled ShareGPT wave on a fresh one) with its logits
    at every draw."""
    from repro.models.sampling import SamplingParams as RefParams
    ref_cfg, jp, _, _ = weights
    recs = {}
    cur = {}
    orig = ref_server.sampling.sample_tokens

    def spy(logits, temp, top_k, top_p, seed, index):
        jax.debug.callback(lambda lg, ix: _record(cur["srv"], cur["rec"],
                                                  lg, ix), logits, index)
        return orig(logits, temp, top_k, top_p, seed, index)

    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_server.sampling, "sample_tokens", spy)
        srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **KW)
        for name, reqs in _mixes(ref_server).items():
            cur.update(srv=srv, rec=recs.setdefault(name, {}))
            srv.serve(reqs)
            jax.effects_barrier()
            outs[name] = [r.output for r in reqs]
        reqs = _mixes(ref_server)["sharegpt"]
        for i, r in enumerate(reqs):
            r.sampling = RefParams(seed=100 + i, **SAMPLED)
        srv = ref_server.ChunkedServer(ref_cfg, jp, kernel=False, **KW)
        cur.update(srv=srv, rec=recs.setdefault("sampled", {}))
        srv.serve(reqs)
        jax.effects_barrier()
        outs["sampled"] = [r.output for r in reqs]
    return outs, recs


def _host_state(srv) -> dict:
    """The scheduler's host-side state: block tables, pool refcounts and
    residency, the radix tree's (tokens, blocks) nodes, the mirrors."""
    nodes, stack = [], [srv.prefix_cache.root]
    while stack:
        n = stack.pop()
        nodes.append((n.tokens.tobytes(), tuple(n.blocks)))
        stack.extend(n.children.values())
    return {"block_table": srv.block_table.tobytes(),
            "refcount": srv.pool.refcount.tobytes(),
            "cached": srv.pool.cached.tobytes(),
            "tree": sorted(nodes), "pos": srv.pos.tobytes(),
            "out_len": srv.out_len.tobytes(),
            "reserved": srv._reserved.tobytes()}


def _mesh(tp):
    return make_tp_mesh(tp, spread="cpu") if tp > 1 else None


@pytest.fixture(scope="module")
def port(weights):
    """The port's streams, stats and host state at tp = 1, 2, 4 (the
    same traffic as `reference`)."""
    _, _, cfg, params = weights
    runs = {}
    for tp in (1,) + TPS:
        srv = server.ChunkedServer(cfg, params, mesh=_mesh(tp),
                                   device=None if tp > 1 else "cpu", **KW)
        run = {"outs": {}, "stats": {}, "host": {}}
        for name, reqs in _mixes(server).items():
            run["stats"][name] = srv.serve(reqs)
            run["outs"][name] = [r.output for r in reqs]
            run["host"][name] = _host_state(srv)
        run["counts"] = srv.compile_counts()
        run["launches"] = dict(srv.launch_counts())
        reqs = _mixes(server)["sharegpt"]
        for i, r in enumerate(reqs):
            r.sampling = SamplingParams(seed=100 + i, **SAMPLED)
        sampled = server.ChunkedServer(cfg, params, mesh=_mesh(tp),
                                       device=None if tp > 1 else "cpu",
                                       **KW)
        sampled.serve(reqs)
        run["outs"]["sampled"] = [r.output for r in reqs]
        run["sampled_counts"] = sampled.compile_counts()
        runs[tp] = run
    return runs


def _draw_margins(lg, sp, pos):
    """The reference's sampled draw's nearness to another
    (tests/test_torch_spec.py): the top-2 gap of z + g, and the top-k
    boundary gap of z."""
    import jax.numpy as jnp
    z = (lg / np.float32(sp.temperature)).astype(np.float32)
    desc = np.sort(z)[::-1]
    kgap = float(desc[sp.top_k - 1] - desc[sp.top_k])
    z = np.where(z >= desc[sp.top_k - 1], z, -np.inf).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.int32(sp.seed)),
                             jnp.int32(pos))
    s = z + np.asarray(jax.random.gumbel(key, z.shape, jnp.float32))
    top = np.sort(s[np.isfinite(s)])
    return float(top[-1] - top[-2]), kgap


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mix", MIX_NAMES + ("sampled",))
def test_tp_streams_match_the_references_tp1(reference, port, tp, mix):
    """Every stream equals the reference's tp=1 stream, or parts at a
    draw within the reference's margin there."""
    ref_outs, recs = reference
    reqs = _mixes(server)[mix if mix != "sampled" else "sharegpt"]
    parted = 0
    for i, (got, want) in enumerate(zip(port[tp]["outs"][mix],
                                        ref_outs[mix])):
        if got == want:
            continue
        parted += 1
        n = min(len(got), len(want))
        j = next((k for k in range(n) if got[k] != want[k]), n)
        lg = recs[mix][(reqs[i].rid, j)]
        if mix == "sampled":
            sp = SamplingParams(seed=100 + i, **SAMPLED)
            gaps = _draw_margins(lg, sp, len(reqs[i].prompt) + j)
            assert min(gaps) <= MARGIN / SAMPLED["temperature"], (i, j, gaps)
        else:
            top = np.sort(lg)
            assert top[-1] - top[-2] <= MARGIN, (i, j, top[-1] - top[-2])
    print(f"tp={tp} {mix}: {parted}/{len(reqs)} streams parted from the "
          "reference's tp=1, each within its margin")


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mix", MIX_NAMES + ("sampled",))
def test_tp_streams_equal_the_ports_tp1(port, tp, mix):
    assert port[tp]["outs"][mix] == port[1]["outs"][mix]


def test_sampled_differs_from_greedy(port):
    assert port[1]["outs"]["sampled"] != port[1]["outs"]["sharegpt"]


@pytest.mark.parametrize("tp", TPS)
def test_host_state_equal_across_tp(port, tp):
    for mix in MIX_NAMES:
        assert port[tp]["host"][mix] == port[1]["host"][mix], mix
        a, b = port[tp]["stats"][mix], port[1]["stats"][mix]
        for key in ("chunk_steps", "decode_spans", "spec_steps",
                    "spec_accepted_tokens", "peak_blocks_in_use",
                    "admission_stalls", "prefix_cached_tokens",
                    "cache_evictions", "cached_blocks", "tokens"):
            assert a[key] == b[key], (mix, key)
        assert a["tp"] == tp and b["tp"] == 1


@pytest.mark.parametrize("tp", (1,) + TPS)
def test_one_program_per_unit(port, tp):
    for counts in (port[tp]["counts"], port[tp]["sampled_counts"]):
        assert counts["chunk_step"] == 1 and counts["verify_step"] == 1
        assert counts["decode_span"] in (0, 1)


def test_tight_pool_stalls_and_serves_tp1s_tokens(weights, port):
    _, _, cfg, params = weights
    tight = server.ChunkedServer(cfg, params, mesh=_mesh(2), num_blocks=4,
                                 **KW)
    reqs = _mixes(server)["sharegpt"]
    stats = tight.serve(reqs)
    assert stats["admission_stalls"] > 0
    assert stats["peak_blocks_in_use"] <= 4
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == port[1]["outs"]["sharegpt"]


@pytest.mark.parametrize("tp", TPS)
def test_kv_bytes_per_device_shrink_by_tp(port, tp):
    per = port[tp]["stats"]["sharegpt"]["kv_bytes_per_device"]
    assert per * tp == port[1]["stats"]["sharegpt"]["kv_bytes_per_device"]


def _step_inputs(cfg, B=3, C=5, seed=7):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, C))
                              .astype(np.int32))
    pos = torch.tensor([0, 9, 17], dtype=torch.int32)
    table = torch.from_numpy(np.arange(B * 4, dtype=np.int32)
                             .reshape(B, 4))
    return tokens, pos, table


@pytest.mark.parametrize("tp", TPS)
def test_chunk_and_verify_logits_bitwise_equal_tp1(weights, tp):
    """api.chunk_step then api.verify_step (bf16 pool, the kernels'
    plain versions) at tp against tp=1 on the same weights and inputs:
    logits, verify tokens and every pool byte (joined over the
    positions' KV heads) equal."""
    _, _, cfg, params = weights
    mesh = make_tp_mesh(tp, spread="cpu")
    shards = convert.shard_params(params, cfg, mesh)
    tokens, pos, table = _step_inputs(cfg)
    n = torch.tensor([5, 3, 1], dtype=torch.int32)
    kw = dict(block_size=8, num_blocks=12)
    c1 = api.init_cache(cfg, 3, 32, device="cpu", **kw)
    cN = api.init_cache(cfg, 3, 32, mesh=mesh, **kw)
    assert [c["k"].shape[3] for c in cN] == [cfg.num_kv_heads // tp] * tp
    l1, _ = api.chunk_step(cfg, params, c1, tokens, pos, n, table,
                           kernel=True)
    lN, _ = api.chunk_step(cfg, shards, cN, tokens, pos, n, table,
                           kernel=True, mesh=mesh, mesh_axis="tp")
    assert torch.equal(l1, lN)
    p1, _ = api.verify_step(cfg, params, c1, tokens, pos + 5, table,
                            kernel=True)
    pN, _ = api.verify_step(cfg, shards, cN, tokens, pos + 5, table,
                            kernel=True, mesh=mesh)
    assert torch.equal(p1, pN)
    for k in ("k", "v"):
        assert torch.equal(c1[k], torch.cat([c[k] for c in cN], dim=3))


def test_replicated_kv_heads_when_tp_does_not_divide_them():
    """KH % tp != 0 (2 KV heads over 4 positions): the plan replicates
    wk / wv and the pools (all KH heads at every position), and each
    position attends with every shard's q and keeps its own heads, as
    the reference's `_paged_kernel_call` replicates: the chunk step's
    logits and pools are tp=1's."""
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2)
    params = api.init(cfg, 0, device="cpu")
    mesh = make_tp_mesh(4, spread="cpu")
    shards = convert.shard_params(params, cfg, mesh)
    assert shards[0]["layers"]["attn"]["wk"].shape == \
        params["layers"]["attn"]["wk"].shape
    tokens, pos, table = _step_inputs(cfg)
    n = torch.tensor([5, 3, 1], dtype=torch.int32)
    c1 = api.init_cache(cfg, 3, 32, device="cpu", block_size=8,
                        num_blocks=12)
    cN = api.init_cache(cfg, 3, 32, mesh=mesh, block_size=8, num_blocks=12)
    l1, _ = api.chunk_step(cfg, params, c1, tokens, pos, n, table,
                           kernel=True)
    lN, _ = api.chunk_step(cfg, shards, cN, tokens, pos, n, table,
                           kernel=True, mesh=mesh)
    assert torch.equal(l1, lN)
    for c in cN:
        assert torch.equal(c["k"], c1["k"]) and torch.equal(c["v"], c1["v"])


def test_verify_logits_bitwise_equal_tp1(weights, monkeypatch):
    """The verify step's full [B, C, V] logits (read at the sample
    head) at tp=4 equal tp=1's, bit for bit."""
    from repro_torch.models import transformer
    _, _, cfg, params = weights
    seen = []
    orig = transformer.sampling.sample_tokens

    def spy(logits, *a):
        seen.append(logits.clone())
        return orig(logits, *a)

    monkeypatch.setattr(transformer.sampling, "sample_tokens", spy)
    tokens, pos, table = _step_inputs(cfg)
    sample = (torch.full((3,), 0.8), torch.full((3,), 8, dtype=torch.int32),
              torch.ones(3), torch.arange(3, dtype=torch.int32))
    mesh = make_tp_mesh(4, spread="cpu")
    for p, cache, kw in (
            (params, api.init_cache(cfg, 3, 32, device="cpu", block_size=8,
                                    num_blocks=12), {}),
            (convert.shard_params(params, cfg, mesh),
             api.init_cache(cfg, 3, 32, mesh=mesh, block_size=8,
                            num_blocks=12), {"mesh": mesh})):
        api.verify_step(cfg, p, cache, tokens, pos, table, kernel=True,
                        sample=sample, **kw)
    assert seen[0].shape == (3, 5, cfg.vocab_size)
    assert torch.equal(seen[0], seen[1])


def test_shard_params_lays_the_plans_slices(weights):
    """Each position's leaf is its slice of the full leaf along the
    plan's split dim (contiguous, its own storage); replicated leaves
    are one tensor shared by the positions of a device."""
    _, _, cfg, params = weights
    mesh = make_tp_mesh(2, spread="cpu")
    shards = convert.shard_params(params, cfg, mesh)
    wq = params["layers"]["attn"]["wq"]
    assert torch.equal(shards[1]["layers"]["attn"]["wq"], wq[:, :, 2:])
    wo = params["layers"]["attn"]["wo"]
    assert torch.equal(shards[0]["layers"]["attn"]["wo"], wo[:, :2])
    emb = params["embed"]
    assert torch.equal(shards[1]["embed"], emb[128:])
    assert shards[0]["layers"]["attn"]["wq"].is_contiguous()
    assert shards[0]["final_norm"]["scale"] is \
        shards[1]["final_norm"]["scale"]


@pytest.mark.parametrize("case", ["moe", "fp8_linear", "kv_heads",
                                  "groups", "two_axes", "no_spread",
                                  "mesh_and_tp"])
def test_refusals(weights, case):
    _, _, cfg, params = weights
    kw = dict(KW)
    if case == "moe":
        mcfg = reduced_config("moonshot-v1-16b-a3b")
        mp = api.init(mcfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="dense/vlm"):
            server.ChunkedServer(mcfg, mp, mesh=_mesh(2), **kw)
    elif case == "fp8_linear":
        with pytest.raises(NotImplementedError, match="tp=1"):
            server.ChunkedServer(cfg, params, mesh=_mesh(2),
                                 fp8_linear=True, **kw)
    elif case == "kv_heads":
        c2 = dataclasses.replace(cfg, num_kv_heads=2, num_heads=4)
        p2 = api.init(c2, 0, device="cpu")
        with pytest.raises(ValueError, match="num_kv_heads"):
            server.ChunkedServer(c2, p2, mesh=_mesh(4), **kw)
    elif case == "groups":
        c3 = dataclasses.replace(cfg, d_ff=130)     # gm = 2
        p3 = api.init(c3, 0, device="cpu")
        with pytest.raises(ValueError, match="reduction"):
            server.ChunkedServer(c3, p3, mesh=_mesh(4), **kw)
    elif case == "two_axes":
        mesh = Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], object),
                    ("data", "model"))
        with pytest.raises(ValueError, match="one"):
            server.ChunkedServer(cfg, params, mesh=mesh, **kw)
    elif case == "no_spread":
        # tp beyond the visible CUDA devices, without the explicit spread
        with pytest.raises(ValueError, match="spread"):
            server.ChunkedServer(cfg, params, tp=2, device="cpu", **kw)
    else:
        with pytest.raises(ValueError, match="disagree"):
            server.ChunkedServer(cfg, params, tp=4, mesh=_mesh(2), **kw)


def test_cli_tp_spread_on_the_cpu(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--device", "cpu", "--tp", "2", "--spread",
                        "--requests", "3", "--slots", "2",
                        "--spec-decode", "2"])
    out = capsys.readouterr().out
    assert stats["tp"] == 2.0 and "tp-mesh: 2 positions" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--tp", "2", "--spread", "--engine",
                    "slot"])
