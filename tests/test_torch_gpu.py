"""The CUDA kernels of the port on the card (marker `gpu`).

This file imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each test decides inside its `cuda` fixture whether a card is present
and skips without one.  The kernels are held against their plain
versions on the same inputs.  Paged attention (kernels/paged_attention.py):
float32 q within 2e-5, bf16 q within 2e-2 and within one bf16 step
(2**-7) of its row's max |o| (at long contexts |o| is small), on
bf16/float32 pools and on e4m3 pools with per-row scales, at head_dim
80 and past 8192 positions, on every split count the plan takes,
bitwise equal from call to call and under a CUDA-graph replay, counted
by body, every plan scheduled on the card.
Matrix products (kernels/{matmul,fp8_matmul,async_pipeline}.py), each
case on the body its rule names: the limits of the reference's
tests/test_kernels.py on its cases; at other shapes float32 within rtol
1e-5 / atol 1e-4, bf16 outputs within one bf16 rounding step (2**-7 of
the value) plus 2**-12 of the largest (the float32 sums run in another
order), integers exact.  DPX and
thread-block-cluster kernels (kernels/{dpx_kernel,dsm}.py): exact
(integer results, float32 ring sums added in the same order).  Flash
attention (kernels/flash_attention.py, B9; bodies wgmma, mma_sync and
fma by dtype and head_dim) against the blockwise forward in torch ops:
float32 o within 1e-4, bf16 o within one bf16 step of max |o| (2**-7),
lse within 1e-4 of max(1, max |lse|); gradients with the kernel forward
against the plain forward within 1e-4 (float32) or 2**-5 of max |g|
(bf16: the backward reads the bf16 output); the training loop restarts
bit-exactly on the card.
The sample head (models/sampling.py) on the card: its random bits and
uniforms equal the CPU's bit for bit, its Gumbel noise within two units
of max(ulp(g), ulp(1)) (the card's log), its tokens equal except where
the CPU's own draw is that close to another.  `verify_step` through the
paged chunk kernel at K = 1, 2, 4 (bf16 and fp8): each kernel call
within the paged limits of its plain version on the same inputs, the
tokens equal to the gather path's but for small top-2 margins; a
rolled-back verify window leaves nothing a later verify reads.
The contiguous layout (``paged=False``) and `SlotServer` on the card:
graph replays equal eager units bit for bit and no paged kernel runs
(the wrappers' counts and the kernel's own counter); open-loop
`serve_online` on a closed stream equals `serve()`, and sync debug
mode finds no synchronization around a warm online wave that a
`serve()` wave does not have, and none inside a dispatch.
The memory-hierarchy kernels (kernels/memory.py): the chase's last
index, the stream and the on-chip checksums exactly their plain
versions'.  The Transformer Engine slice (te/): `fp8_dot` at K and N
that are not multiples of 16 and on mixed e4m3 / e5m2 operands within
2**-8 of the largest |value| of the plain product (fp8 tensor-core sums
keep about 14 bits between float32 promotions); `te_linear` forward and
backward on the card against the port on the CPU (codes and states
bitwise, outputs within one bf16 step of each value plus 2**-8 of the
largest); `te_transformer_layer` with no host synchronization and one
B9 launch a call; the memory and TE benchmarks through the kernels.
Tensor-parallel serving (``ChunkedServer(mesh=make_tp_mesh(tp,
spread=<card>))``): at tp=2 graph replays equal eager units bit for bit
(streams and every position's pools; chunk, span or verify, and
copy-on-write units), each graph launching both positions' paged
kernels; each position's pools dense, of KH/tp heads, in storage of its
own.
The state-space families (models/ssm.py, ssm_lm.py, hybrid.py): each
reduced mixer card against CPU (float32 within 1e-5, bf16 within four
bf16 steps of max |x|), B9 at zamba2-2.7b's shared-attention shape (hd
80, mma_sync) against its plain version, and the decode step as a
graph-replayed work unit bit for bit against eager steps.
The encoder-decoder family (models/encdec.py): B9 at whisper-small's
encoder (1500 x 1500) and cross-attention (448 x 1500) shapes on wgmma
(forward and gradients by the flash bars), api.prefill at full width
(2 + 2 layers) launching B9 once an encoder layer on wgmma, the reduced
model's decode step as a graph-replayed work unit bit for bit against
eager steps, and optim/compress.apply_ef on the card bit for bit the
CPU's.
The serving-contract analyzer (repro_torch.analysis) on the card: the
work-unit layer over every flag combo clean, each unit one program and
one CUDA graph after 3+ calls, its captured graph launching the pool's
paged kernels; a host read inside a body caught by sync debug mode
(JX001), while the same body without it captures once and replays
clean; a recapture counted and named by JX005; the launch lint's 13 workloads run and every planned launch
matched by one real launch, none unplanned; the CLI strict and clean.
The sharded training step (models/transformer.sharded_loss_fn): the
reduced fsdp_tp step on a (2, 4) mesh spread over the card against the
same step on a mesh spread over the CPU (bf16: loss within 2e-3, each
gradient within 5% of its norm), B9 at the shards' heads.
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import dpx as core_dpx
from repro_torch.core import dsm as core_dsm
from repro_torch.kernels import async_pipeline as apk
from repro_torch.kernels import build
from repro_torch.kernels import dpx_kernel as dk
from repro_torch.kernels import dsm as dsk
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fp8_matmul as f8k
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import memory as memk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import api, attention, sampling, transformer
from repro_torch.runtime import server
from repro_torch.runtime.graphs import WorkUnit
from repro_torch.te import fp8

CASES = [       # the CASES of tests/test_paged_kernel.py, then more
    # dtype      B  H  KH  hd  NB  bs  MB seed
    ("float32",  3, 4, 2, 32, 24,  8,  6, 0),
    ("bfloat16", 3, 4, 2, 32, 24,  8,  6, 1),
    ("float32",  2, 6, 6, 16, 17,  4,  8, 3),
    ("bfloat16", 4, 8, 2, 64, 32, 16,  4, 5),
    ("float32",  6, 8, 4, 64, 40, 16,  5, 7),
    # head_dim 80: zamba2-2.7b's heads (H=32, KH=32) and a G=4 case
    ("bfloat16", 3, 32, 32, 80, 24,  8,  6, 11),
    ("float32",  3, 32, 32, 80, 24,  8,  6, 12),
    ("bfloat16", 3, 8, 2, 80, 24,  8,  6, 13),
    ("float32",  3, 8, 2, 80, 24,  8,  6, 14),
    # 8192 positions, past the 7008 the whole-row kernel held
    ("bfloat16", 3, 8, 2, 64, 1560, 16, 512, 15),
    ("float32",  3, 8, 2, 128, 1560, 16, 512, 16),
]
LIMIT = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_STEP = 2.0 ** -7


def _paged_err_ok(got, want, dtype) -> tuple:
    """(max abs error, whether every element is within LIMIT and, on
    bf16 q, within one bf16 step of its row's max |want|)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = torch.full_like(want[..., :1], LIMIT[dtype])
    if dtype == "bfloat16":
        limit = limit.minimum(BF16_STEP * want.abs().amax(-1, keepdim=True))
    return diff.max().item(), bool((diff <= limit).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def keep_f32_rows(monkeypatch):
    """Every family's embedding keeps float32 rows, so a step whose
    other inputs are float32 runs in float32 (the CPU tests of the
    sharded step patch the reference's the same way in its child)."""
    import torch.nn.functional as F
    from repro_torch.models import encdec, hybrid, ssm_lm
    rows = (lambda cfg, params, tokens, prefix_embeds=None:
            F.embedding(tokens.long(), params["embed"]))
    for m in (transformer, ssm_lm, hybrid, encdec):
        monkeypatch.setattr(m, "embed_tokens", rows)


def _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, device, C=4, kv_lens=None):
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd))).to(device, td)
    ck = torch.from_numpy(rng.standard_normal((NB, bs, KH, hd))).to(device,
                                                                   td)
    cv = torch.from_numpy(rng.standard_normal((NB, bs, KH, hd))).to(device,
                                                                   td)
    T = MB * bs
    if kv_lens is None:
        kv_lens = [1, bs + bs // 2 + 1, T, T // 2 + 1, bs, 2 * bs - 1]
    kv = np.minimum(np.asarray(kv_lens[:B]), T).astype(np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(kv[b]) // bs):] = -1
    return (q, ck, cv, torch.from_numpy(bt).to(device),
            torch.from_numpy(kv).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", CASES)
def test_kernels_vs_plain(cuda, dtype, B, H, KH, hd, NB, bs, MB, seed):
    q, ck, cv, bt, kv = _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, cuda)
    C = q.shape[1]
    pos = torch.clamp(kv - C, min=0)
    q1 = q[:, :1].contiguous()
    n0 = (pk.paged_decode.launches, pk.paged_chunk.launches)
    got_d = pk.paged_decode(q1, ck, cv, bt, kv)
    got_c = pk.paged_chunk(q, ck, cv, bt, pos)
    torch.cuda.synchronize()
    assert (pk.paged_decode.launches, pk.paged_chunk.launches) == \
        (n0[0] + 1, n0[1] + 1)
    for got, want in ((got_d, pk.paged_decode_plain(q1, ck, cv, bt, kv)),
                      (got_c, pk.paged_chunk_plain(q, ck, cv, bt, pos))):
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, err


def _quantized(ck, cv):
    """e4m3 pools + per-row scales of the pools' float32 values."""
    kq, ks = fp8.quantize_rowwise(ck.float())
    vq, vs = fp8.quantize_rowwise(cv.float())
    return kq, vq, dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", CASES)
def test_fp8_kernels_vs_plain(cuda, dtype, B, H, KH, hd, NB, bs, MB, seed):
    q, ck, cv, bt, kv = _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, cuda)
    kq, vq, sc = _quantized(ck, cv)
    C = q.shape[1]
    pos = torch.clamp(kv - C, min=0)
    q1 = q[:, :1].contiguous()
    n0 = (pk.paged_decode_fp8.launches, pk.paged_chunk_fp8.launches)
    got_d = pk.paged_decode_fp8(q1, kq, vq, bt, kv, **sc)
    got_c = pk.paged_chunk_fp8(q, kq, vq, bt, pos, **sc)
    torch.cuda.synchronize()
    assert (pk.paged_decode_fp8.launches, pk.paged_chunk_fp8.launches) == \
        (n0[0] + 1, n0[1] + 1)
    for got, want in (
            (got_d, pk.paged_decode_fp8_plain(q1, kq, vq, bt, kv, **sc)),
            (got_c, pk.paged_chunk_fp8_plain(q, kq, vq, bt, pos, **sc))):
        assert got.dtype == q.dtype
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, err


def _paged_call(kernel, q, ck, cv, bt, lens, **kw):
    """`kernel` ("paged_decode", ...) on its operands; e4m3 kernels get
    the pools quantized per row."""
    if kernel.endswith("_fp8"):
        kq, vq, sc = _quantized(ck, cv)
        return getattr(pk, kernel)(q, kq, vq, bt, lens, **sc, **kw), \
            getattr(pk, kernel + "_plain")(q, kq, vq, bt, lens, **sc)
    return getattr(pk, kernel)(q, ck, cv, bt, lens, **kw), \
        getattr(pk, kernel + "_plain")(q, ck, cv, bt, lens)


SPLIT_CASES = [CASES[i] for i in (1, 2, 7, 8, 9, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_chunk",
                                    "paged_decode_fp8", "paged_chunk_fp8"])
@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", SPLIT_CASES)
def test_every_split_count_vs_plain(cuda, kernel, dtype, B, H, KH, hd, NB,
                                    bs, MB, seed):
    """Each cluster size the plan can take (1-16, 16 non-portable),
    forced through `splits=`, and for a chunk each row group of 8 and 16
    rows, against the plain version at the same limits; splits past the
    table's tiles leave blocks with no position, which add nothing."""
    q, ck, cv, bt, kv = _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, cuda)
    decode = kernel.startswith("paged_decode")
    q = q[:, :1].contiguous() if decode else q
    lens = kv if decode else torch.clamp(kv - q.shape[1], min=0)
    forced = [dict(splits=s) for s in pk.SPLITS]
    if not decode:
        forced += [dict(rows=8), dict(rows=16), dict(splits=2, rows=8)]
    ran = 0
    for kw in forced:
        try:
            pk.plan(q.dtype, hd, B, KH, H // KH, q.shape[1], MB * bs, **kw)
        except ValueError:
            continue                   # scores of that split do not fit
        got, want = _paged_call(kernel, q, ck, cv, bt, lens, **kw)
        torch.cuda.synchronize()
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, (kw, err)
        ran += 1
    assert ran >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_chunk",
                                    "paged_decode_fp8", "paged_chunk_fp8"])
@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", CASES)
def test_recompute_plan_vs_plain(cuda, kernel, dtype, B, H, KH, hd, NB, bs,
                                 MB, seed, monkeypatch):
    """The plan that recomputes the scores (two passes over K, one tile
    of scores a block), forced on short tables by patching `pk.plan`
    (the wrappers take no such option), at its own splits and at one
    and sixteen splits (blocks with no position), against the plain
    version at the same limits, counted once on its body."""
    q, ck, cv, bt, kv = _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, cuda)
    decode = kernel.startswith("paged_decode")
    q = q[:, :1].contiguous() if decode else q
    lens = kv if decode else torch.clamp(kv - q.shape[1], min=0)
    fn = getattr(pk, kernel)
    held_plan = pk.plan
    monkeypatch.setattr(pk, "plan", lambda *a, **k: held_plan(
        *a, **k, recompute=True))
    for kw in (dict(), dict(splits=1), dict(splits=16)):
        p = pk.plan(q.dtype, hd, B, KH, H // KH, q.shape[1], MB * bs, **kw)
        assert p.recompute
        n0 = dict(fn.body_launches)
        got, want = _paged_call(kernel, q, ck, cv, bt, lens, **kw)
        torch.cuda.synchronize()
        assert fn.body_launches[p.body] == n0[p.body] + 1
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, (kw, err)


# yi-6b's attention heads past the held scores: every slot at `T`
# positions, bf16 and e4m3 pools at 131072, float32 q at 65536
LONG_CASES = [("bfloat16", False, 131072), ("bfloat16", True, 131072),
              ("float32", False, 65536)]


def _long_inputs(dtype, B, T, C, device, seed):
    """q [B, C, 32, 128], pools of B * T / 16 blocks of 16 positions (4
    kv heads), a shuffled full table, every slot at T positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    bs, MB = 16, T // 16
    NB = B * MB
    ck = torch.randn((NB, bs, 4, 128), generator=g, device=device).to(td)
    cv = torch.randn((NB, bs, 4, 128), generator=g, device=device).to(td)
    bt = torch.randperm(NB, generator=g, device=device).reshape(B, MB)
    q = torch.randn((B, C, 32, 128), generator=g, device=device).to(td)
    return q, ck, cv, bt.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fp8_pool,T", LONG_CASES)
def test_long_context_decode_and_chunk_vs_plain(cuda, dtype, fp8_pool, T):
    """Past ~80k positions (bf16 hd 128; 46080 at float32) a cluster no
    longer holds a row's scores: decode at B=2 and a 16-row chunk at B=1
    take the recompute plan and agree with the plain version at phase
    3's limits (the chunk's plain version row by row: its [C, T, hd]
    product would not fit the card)."""
    for kind, B, C in (("decode", 2, 1), ("chunk", 1, 16)):
        q, ck, cv, bt = _long_inputs(dtype, B, T, C, cuda, seed=T + C)
        kw = {}
        if fp8_pool:
            ck, cv, kw = _quantized(ck, cv)
        name = f"paged_{kind}" + ("_fp8" if fp8_pool else "")
        fn, plain = getattr(pk, name), getattr(pk, name + "_plain")
        p = pk.plan(q.dtype, 128, B, 4, 8, C, T)
        assert p.recompute
        lens = torch.full((B,), T if kind == "decode" else T - C,
                          dtype=torch.int32, device=cuda)
        n0 = fn.body_launches[p.body]
        got = fn(q, ck, cv, bt, lens, **kw)
        torch.cuda.synchronize()
        assert fn.body_launches[p.body] == n0 + 1
        if kind == "decode":
            want = plain(q, ck, cv, bt, lens, **kw)
        else:
            want = torch.cat([plain(q[:, c:c + 1].contiguous(), ck, cv, bt,
                                    lens + c, **kw) for c in range(C)], 1)
        assert torch.isfinite(got.float()).all()
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, (kind, err)
        del q, ck, cv, bt, got, want
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_chunk",
                                    "paged_decode_fp8", "paged_chunk_fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_repeat_calls_and_graph_replay_bitwise_equal(cuda, kernel, dtype):
    """No float atomics and a plan that never reads the lengths: two
    calls give the same bits, and a call captured in a CUDA graph and
    replayed (on new lengths written into the captured tensor) equals the
    eager call on those lengths."""
    q, ck, cv, bt, kv = _mk(dtype, 4, 8, 2, 128, 70, 16, 16, 21, cuda)
    decode = kernel.startswith("paged_decode")
    q = q[:, :1].contiguous() if decode else q
    lens = kv if decode else torch.clamp(kv - q.shape[1], min=0)
    if kernel.endswith("_fp8"):
        kq, vq, sc = _quantized(ck, cv)
        call = lambda: getattr(pk, kernel)(q, kq, vq, bt, lens, **sc)
    else:
        call = lambda: getattr(pk, kernel)(q, ck, cv, bt, lens)
    a, b = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                          # warm up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    lens.copy_(torch.clamp(lens - 5, min=0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())


@pytest.mark.gpu
def test_launches_by_body(cuda):
    """Every launch counts once in all and once on its plan's body: bf16
    q on mma_sync, float32 q on fma."""
    pk.reset_launch_counts()
    for dtype in ("bfloat16", "float32", "bfloat16"):
        q, ck, cv, bt, kv = _mk(dtype, 3, 4, 2, 32, 24, 8, 6, 2, cuda)
        pos = torch.clamp(kv - q.shape[1], min=0)
        for kernel in ("paged_decode", "paged_chunk", "paged_decode_fp8",
                       "paged_chunk_fp8"):
            qq = q[:, :1].contiguous() if kernel.startswith(
                "paged_decode") else q
            _paged_call(kernel, qq, ck, cv, bt,
                        kv if qq.shape[1] == 1 else pos)
    torch.cuda.synchronize()
    assert pk.launch_counts() == dict.fromkeys(
        ("paged_decode", "paged_chunk", "paged_decode_fp8",
         "paged_chunk_fp8"), 3)
    assert pk.launches_by_body() == dict.fromkeys(
        ("paged_decode", "paged_chunk", "paged_decode_fp8",
         "paged_chunk_fp8"), {"mma_sync": 2, "fma": 1})


@pytest.mark.gpu
def test_every_plan_schedules_on_the_card(cuda):
    """Every plan of the serving, decode_32k, llama-te-mini and zamba2
    shapes, and each forced cluster size, runs at least one cluster on
    the card (cudaOccupancyMaxActiveClusters), on bf16/float32 and on
    e4m3 pools; the source refuses a plan it does not take."""
    import ctypes
    lib = build.load(pk.SOURCE)
    n = ctypes.c_int(0)
    for dt, hd, B, KH, G, C, T in [
            (torch.bfloat16, 128, 8, 4, 8, 1, 272),
            (torch.bfloat16, 128, 8, 4, 8, 16, 272),
            (torch.bfloat16, 128, 8, 4, 8, 1, 32768),
            (torch.bfloat16, 128, 8, 4, 8, 16, 32768),
            (torch.float32, 128, 8, 4, 8, 16, 272),
            (torch.bfloat16, 64, 8, 12, 1, 1, 272),
            (torch.bfloat16, 80, 8, 32, 1, 16, 272),
            (torch.bfloat16, 128, 2, 4, 8, 1, 131072),
            (torch.bfloat16, 128, 1, 4, 8, 16, 131072),
            (torch.float32, 128, 2, 4, 8, 1, 65536),
            (torch.float32, 128, 1, 4, 8, 16, 65536)]:
        for s in (0,) + pk.SPLITS:
            try:
                p = pk.plan(dt, hd, B, KH, G, C, T, splits=s)
            except ValueError:
                continue
            for fp8_pools in (0, 1):
                assert lib.paged_attention_max_clusters(
                    pk._DTYPES[dt], fp8_pools, hd, G, C, T, p.splits, p.rows,
                    int(p.recompute), ctypes.addressof(n)) == 0
                assert n.value >= 1, (dt, hd, B, KH, G, C, T, s)
    for splits, rows, recompute in ((3, 8, 0), (32, 8, 0), (2, 12, 0),
                                    (2, 136, 0), (0, 8, 0), (2, 0, 0),
                                    (2, 8, 2)):
        assert lib.paged_attention_max_clusters(
            1, 0, 128, 8, 1, 272, splits, rows, recompute,
            ctypes.addressof(n)) != 0
    long = 4 * pk.held_scores_context(torch.bfloat16, 128)
    assert lib.paged_attention_max_clusters(          # past SMEM_LIMIT
        1, 0, 128, 8, 1, long, 16, 8, 0, ctypes.addressof(n)) != 0
    assert lib.paged_attention_max_clusters(          # recomputed: fits
        1, 0, 128, 8, 1, long, 16, 8, 1, ctypes.addressof(n)) == 0


@pytest.mark.gpu
def test_fp8_serving_dot_every_layer(cuda):
    """The e4m3 product (torch._scaled_mm) runs on every layer's slice
    of a quantized stacked weight, and agrees with its plain version
    within one bf16 step of each output plus 2**-12 of the largest (the
    float32 sums run in another order, which shows on outputs near 0):
    cuBLASLt refuses an unaligned scale pointer, which a packed [L]
    scale array gives every layer past the first."""
    from repro_torch.te import linear
    g = torch.Generator(device=cuda).manual_seed(0)
    leaf = linear._quantize_leaf(
        torch.randn((3, 64, 4, 16), generator=g, device=cuda), 1)
    x = torch.randn((3, 8, 64), generator=g, device=cuda).bfloat16()
    for i in range(3):
        sl = {k: v[i] for k, v in leaf.items()}
        got = linear.fp8_serving_dot(x, sl).float()
        want = linear.fp8_serving_dot(
            x.cpu(), {k: v.cpu() for k, v in sl.items()}).float()
        assert got.shape == (3, 8, 4, 16)
        assert ((got.cpu() - want).abs() <= 2.0 ** -7 * want.abs()
                + 2.0 ** -12 * want.abs().max()).all(), i


@pytest.mark.gpu
def test_kernel_never_reads_unallocated_blocks(cuda):
    """NaN in block 0, reachable only through -1 entries: the walk
    stops at the row bound, so the output is the clean-pool output."""
    q, ck, cv, bt, kv = _mk("float32", 3, 4, 2, 32, 24, 8, 6, 19, cuda,
                            C=1, kv_lens=[5, 20, 33])
    bt_np = bt.cpu().numpy()
    free = [i for i in range(24) if i not in set(bt_np.ravel())]
    bt_np[bt_np == 0] = free.pop()
    bt = torch.from_numpy(bt_np).to(cuda)
    clean = pk.paged_decode(q, ck, cv, bt, kv)
    ck[0], cv[0] = float("nan"), float("nan")
    assert torch.equal(pk.paged_decode(q, ck, cv, bt, kv), clean)


@pytest.mark.gpu
def test_fp8_kernels_never_read_unallocated_blocks(cuda):
    """NaN codes (0x7f) and NaN scales in block 0, reachable only
    through -1 entries: decode and chunk outputs equal the clean-pool
    outputs."""
    q, ck, cv, bt, kv = _mk("bfloat16", 3, 4, 2, 32, 24, 8, 6, 19, cuda,
                            C=2, kv_lens=[5, 20, 33])
    bt_np = bt.cpu().numpy()
    free = [i for i in range(24) if i not in set(bt_np.ravel())]
    bt_np[bt_np == 0] = free.pop()
    bt = torch.from_numpy(bt_np).to(cuda)
    kq, vq, sc = _quantized(ck, cv)
    q1, pos = q[:, :1].contiguous(), kv - 2
    clean = (pk.paged_decode_fp8(q1, kq, vq, bt, kv, **sc),
             pk.paged_chunk_fp8(q, kq, vq, bt, pos, **sc))
    for pool in (kq, vq):
        pool.view(torch.uint8)[0] = 0x7F
    for s in sc.values():
        s[0] = float("nan")
    got = (pk.paged_decode_fp8(q1, kq, vq, bt, kv, **sc),
           pk.paged_chunk_fp8(q, kq, vq, bt, pos, **sc))
    assert torch.isnan(kq[0].float()).all()
    for g, c in zip(got, clean):
        assert torch.equal(g, c)


@pytest.mark.gpu
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, ck, cv, bt, kv = _mk("float32", 2, 4, 2, 32, 24, 8, 6, 0, cuda, C=1)
    with pytest.raises(TypeError):
        pk.paged_decode(q, ck.bfloat16(), cv.bfloat16(), bt, kv)
    with pytest.raises(ValueError):
        pk.paged_decode(q, ck, cv, bt.cpu(), kv)
    with pytest.raises(ValueError):
        pk.paged_chunk(q, ck[:, :, :, :16].contiguous(),
                       cv[:, :, :, :16].contiguous(), bt, kv)


@pytest.mark.gpu
@pytest.mark.parametrize("fp8_opts", [{}, dict(fp8_kv=True,
                                              fp8_linear=True)],
                         ids=["bf16", "fp8"])
def test_decode_span_reads_nothing_back(cuda, fp8_opts):
    """A decode span through the kernels takes no host sync: the pool
    scatter (and the fp8 quantization, its scales and the fp8 products),
    the kernels, the sample head and the span bookkeeping stay on the
    device, in the unit's eager call and in its graph's replays
    (torch.cuda's sync debug mode raises on any sync); the launches of
    a replay are counted as those of the eager call."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                               chunk=8, span=4, block_size=8, device=cuda,
                               **fp8_opts)
    key = "paged_decode_fp8" if fp8_opts else "paged_decode"
    srv.block_table[:, :2] = np.arange(2 * srv.B).reshape(srv.B, 2)
    unit = srv._units["decode_span"]
    ops = (np.full(srv.B, 3, np.int32), np.zeros(srv.B, np.int32),
           np.ones(srv.B, bool), np.full(srv.B, 8, np.int32),
           *srv._samp_mirrors(), srv.block_table)
    unit.run(*ops)                      # the first call: eager, set-up
    unit.run(*ops)                      # capture + one replay
    torch.cuda.synchronize()
    n0 = srv.launch_counts()[key]
    torch.cuda.set_sync_debug_mode("error")
    try:
        unit._eager(*ops)
        unit.run(*ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert unit.captures == 1 and unit.calls == 4
    assert srv.launch_counts()[key] == n0 + 2 * srv.span * cfg.num_layers


# ----------------------------------------------------------------------
# one CUDA graph per work unit
# ----------------------------------------------------------------------

GRAPH_SERVERS = {
    "bf16": dict(),
    "fp8": dict(fp8_kv=True, fp8_linear=True),
    "bf16-spec": dict(spec_decode=3),
    "fp8-spec": dict(spec_decode=3, fp8_kv=True, fp8_linear=True),
}


def _graph_waves(srv, cfg, sampled):
    """Two shared-prompt waves (the second meets the first's prefixes and
    copies on write) then a repetitive one; returns the streams."""
    outs = []
    for reqs in (
            server.sysprompt_sharegpt_requests(
                6, cfg.vocab_size, num_templates=2, template_len=12,
                max_input=20, max_output=8, seed=4),
            server.sysprompt_sharegpt_requests(
                6, cfg.vocab_size, num_templates=2, template_len=12,
                max_input=20, max_output=8, seed=4),
            server.repetitive_requests(6, cfg.vocab_size, motif_len=4,
                                       reps=3, max_output=12, seed=5)):
        for i, r in enumerate(reqs):
            if sampled:
                r.sampling = sampling.SamplingParams(temperature=0.8,
                                                     top_k=20, seed=i)
        srv.serve(reqs)
        assert all(r.done for r in reqs)
        outs.append([r.output for r in reqs])
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", list(GRAPH_SERVERS))
def test_graph_replays_equal_eager_units(cuda, mode, sampled):
    """Two fresh servers serve the same waves, one through its units'
    graphs, one through their private eager calls: equal streams, and
    equal pools, current tokens, output buffers and n-gram tables, bit
    for bit.  On the graph server every unit was captured once (and
    replayed), each reports one program, and the eager server none."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
              device=cuda, **GRAPH_SERVERS[mode])
    graphed = server.ChunkedServer(cfg, params, **kw)
    eager = server.ChunkedServer(cfg, params, **kw)
    for unit in eager._units.values():
        unit.run = unit._eager
    assert _graph_waves(graphed, cfg, sampled) == _graph_waves(
        eager, cfg, sampled)
    for name in ("cache", "cur_tok", "out_buf", "ngram_table"):
        a, b = getattr(graphed, name, None), getattr(eager, name, None)
        if isinstance(a, dict):
            assert all(torch.equal(a[k].view(torch.uint8), b[k].view(
                torch.uint8)) for k in a), name
        elif a is not None:
            assert torch.equal(a, b), name
    want = {"chunk_step": 1, "decode_span": 1, "cow_copy": 1}
    if "spec" in mode:
        want = dict(want, decode_span=0, verify_step=1)
    assert graphed.compile_counts() == eager.compile_counts() == want
    for name, unit in graphed._units.items():
        if want[name]:
            assert unit.calls >= 3 and unit.captures == 1, name
            assert eager._units[name].captures == 0


@pytest.mark.gpu
def test_replays_add_their_captured_launches(cuda):
    """A replay adds the launches counted while its graph was captured:
    a span's decode kernel once a layer a step, a chunk step's and a
    verify step's chunk kernel once a layer, nothing else; and the
    kernel's own counter on the card (`device_launches`) sees as many
    launches run, over the whole wave and over each replay."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                               chunk=8, span=4, block_size=8, device=cuda,
                               spec_decode=3)
    d0, n0 = pk.device_launches(cuda), sum(srv.launch_counts().values())
    srv.serve(server.repetitive_requests(6, cfg.vocab_size, motif_len=4,
                                         reps=3, max_output=12, seed=5))
    assert pk.device_launches(cuda) - d0 == \
        sum(srv.launch_counts().values()) - n0
    L = cfg.num_layers
    want = {"chunk_step": {"paged_chunk": L}, "verify_step":
            {"paged_chunk": L}}
    for name, kernels in want.items():
        unit = srv._units[name]
        assert unit.captures == 1
        got = {k: n for k, (n, _) in unit.replay_launches.items() if n}
        assert got == kernels
        assert unit.replay_launches["paged_chunk"][1] == {"mma_sync": L,
                                                          "fma": 0}
        ops = [t.cpu().numpy() for t in unit._inputs]
        d0 = pk.device_launches(cuda)
        n0, b0 = srv.launch_counts(), pk.launches_by_body()
        unit.run(*ops)
        torch.cuda.synchronize()
        n1, b1 = srv.launch_counts(), pk.launches_by_body()
        assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == kernels
        assert pk.device_launches(cuda) - d0 == L
        assert b1["paged_chunk"]["mma_sync"] - b0["paged_chunk"][
            "mma_sync"] == L


@pytest.mark.gpu
def test_greedy_wave_syncs_only_at_its_dispatch_ends(cuda):
    """Once its units are captured (a capture synchronizes the device
    once), a greedy wave without EOS raises nothing under torch.cuda's
    sync debug mode "error" between each dispatch and its `_sync`:
    staging copies from pinned memory, graph replays and launch
    counting, no host read."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                               chunk=8, span=4, block_size=8, device=cuda)

    def wave(seed):
        return server.sharegpt_like_requests(6, cfg.vocab_size,
                                             max_input=16, max_output=8,
                                             seed=seed)

    srv.serve(wave(3))
    runs = []
    for unit in srv._units.values():
        def checked(*ops, _run=unit.run):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _run(*ops)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                runs.append(1)
        unit.run = checked
    second = wave(7)
    srv.serve(second)
    assert len(runs) >= 4 and all(r.done for r in second)
    assert srv._units["chunk_step"].captures == 1
    assert srv._units["decode_span"].captures == 1


# ----------------------------------------------------------------------
# the contiguous layout, the slot baseline and open-loop serving
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("spec", [0, 3], ids=["span", "spec"])
def test_contiguous_graph_replays_equal_eager_units(cuda, spec):
    """paged=False on the card: a server whose units replay graphs and
    one whose units run eagerly serve the same waves to the same
    streams, caches, current tokens, output buffers and n-gram tables,
    bit for bit; each unit one program, captured once; no copy-on-write
    unit; and no paged kernel ran (the wrappers' counts and the
    kernel's own counter on the card stay put)."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, paged=False,
              spec_decode=spec, device=cuda)
    graphed = server.ChunkedServer(cfg, params, **kw)
    eager = server.ChunkedServer(cfg, params, **kw)
    for unit in eager._units.values():
        unit.run = unit._eager
    d0, n0 = pk.device_launches(cuda), pk.launch_counts()
    assert _graph_waves(graphed, cfg, False) == _graph_waves(eager, cfg,
                                                             False)
    assert pk.device_launches(cuda) == d0 and pk.launch_counts() == n0
    for name in ("cur_tok", "out_buf", "ngram_table"):
        a, b = getattr(graphed, name, None), getattr(eager, name, None)
        assert a is None or torch.equal(a, b), name
    assert all(torch.equal(graphed.cache[k], eager.cache[k])
               for k in ("k", "v"))
    want = ({"chunk_step": 1, "decode_span": 0, "verify_step": 1} if spec
            else {"chunk_step": 1, "decode_span": 1})
    assert graphed.compile_counts() == eager.compile_counts() == want
    for name, unit in graphed._units.items():
        if want[name]:
            assert unit.calls >= 3 and unit.captures == 1, name


@pytest.mark.gpu
def test_slot_server_on_card(cuda, monkeypatch):
    """SlotServer on the card: every request complete, one decode
    program and one prefill program a distinct prompt length (the
    reference's counts), its graphs' streams equal its eager units',
    and no paged kernel ran."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    reqs = server.sharegpt_like_requests(8, cfg.vocab_size, max_input=12,
                                         max_output=6, seed=2)
    outs = []
    d0, n0 = pk.device_launches(cuda), pk.launch_counts()
    for eager in (False, True):
        if eager:               # every unit of this server runs eagerly
            monkeypatch.setattr(WorkUnit, "run", WorkUnit._eager)
        srv = server.SlotServer(cfg, params, batch_slots=3, max_len=32,
                                device=cuda)
        rs = server.clone_requests(reqs)
        srv.serve(rs)
        assert all(r.done and len(r.output) == r.max_new for r in rs)
        assert srv.compile_counts() == {
            "decode_step": 1,
            "prefill_one": len({len(r.prompt) for r in reqs})}
        outs.append([r.output for r in rs])
        assert eager or srv._decode.captures == 1
    assert outs[0] == outs[1]
    assert pk.device_launches(cuda) == d0 and pk.launch_counts() == n0


def _sync_warnings(fn) -> collections.Counter:
    """The places (file, line) of the synchronizations torch.cuda's sync
    debug mode "warn" reports while `fn` runs."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter((w.filename, w.lineno) for w in seen
                               if "synchroniz" in str(w.message).lower())


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_online_wave_equals_serve_and_syncs_no_more(cuda, paged):
    """On the card: serve_online on a closed stream gives serve()'s
    streams and compile counts; around one warm wave of each on the
    same traffic (no prefix cache, so the dispatches repeat), sync
    debug mode reports no synchronization of the online loop that
    serve() does not have (by place and count), and none inside any
    dispatch ("error" around each unit's call)."""
    from repro_torch.runtime.arrivals import closed_stream
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
              paged=paged, prefix_cache=False, device=cuda)

    def wave(seed):
        return server.sharegpt_like_requests(6, cfg.vocab_size,
                                             max_input=16, max_output=8,
                                             seed=seed)

    a, b = server.ChunkedServer(cfg, params, **kw), server.ChunkedServer(
        cfg, params, **kw)
    ra, rb = wave(3), wave(3)
    a.serve(ra)
    b.serve_online(closed_stream(rb))
    assert [r.output for r in ra] == [r.output for r in rb]
    assert a.compile_counts() == b.compile_counts()
    n_serve = _sync_warnings(lambda: a.serve(wave(7)))
    runs = []
    for unit in b._units.values():
        def checked(*ops, _run=unit.run):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _run(*ops)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                runs.append(1)
        unit.run = checked
    online = wave(7)
    n_online = _sync_warnings(
        lambda: b.serve_online(closed_stream(online)))
    assert len(runs) >= 4 and all(r.done for r in online)
    assert not n_online - n_serve, (n_online, n_serve)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["chunked", "slot"])
def test_a_dead_server_is_collected_before_a_capture(cuda, engine):
    """A server is a reference cycle (its units' bodies are its bound
    methods), so only the garbage collector frees a dead one, with its
    graphs, pinned staging and events.  A unit collects before it
    captures and keeps the collector off while it captures: a collection
    forced inside a live server's capture finds the dead server gone,
    and the capture holds."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)

    def make():
        if engine == "slot":
            return server.SlotServer(cfg, params, batch_slots=3, max_len=32,
                                     device=cuda)
        return server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                                    chunk=8, span=4, block_size=8,
                                    device=cuda)

    def wave():
        return server.sharegpt_like_requests(6, cfg.vocab_size,
                                             max_input=12, max_output=6,
                                             seed=3)

    dead = make()
    dead.serve(wave())
    gone = weakref.ref(dead)
    del dead
    live = make()
    unit = live._decode if engine == "slot" else live._units["chunk_step"]
    seen = []

    def collecting(*ops, _body=unit._body):
        if torch.cuda.is_current_stream_capturing():
            seen.append((gc.isenabled(), gone() is None))
            gc.collect()
        return _body(*ops)

    unit._body = collecting
    reqs = wave()
    live.serve(reqs)
    assert all(r.done for r in reqs) and unit.captures == 1
    assert seen == [(False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("fp8_opts", [{}, dict(fp8_kv=True,
                                              fp8_linear=True)],
                         ids=["bf16", "fp8"])
def test_server_on_card_completes_and_launches_both_kernels(cuda, fp8_opts):
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                               chunk=8, span=4, block_size=8, device=cuda,
                               **fp8_opts)
    keys = (("paged_decode_fp8", "paged_chunk_fp8") if fp8_opts
            else ("paged_decode", "paged_chunk"))
    n0 = srv.launch_counts()
    reqs = server.sysprompt_sharegpt_requests(
        6, cfg.vocab_size, num_templates=2, template_len=12, max_input=20,
        max_output=6, seed=4)
    srv.serve(reqs)
    assert all(r.done and len(r.output) == r.max_new for r in reqs)
    n1 = srv.launch_counts()
    assert all(n1[k] > n0[k] for k in keys)


# ----------------------------------------------------------------------
# the sample head, verify_step and speculative decoding
# ----------------------------------------------------------------------

GUMBEL_ULPS = 2
EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [0, 5])
def test_sample_head_on_card_equals_cpu(cuda, dtype, C):
    rng = np.random.default_rng(C)
    B, V = 8, 64000
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, B)).to(
        torch.int32)
    index = torch.from_numpy(rng.integers(0, 2 ** 31, (B, C) if C else B))
    index = index.to(torch.int32)
    key = sampling.fold_in(sampling.prng_key(seeds[:, None].expand(-1, 3)),
                           index.reshape(B, -1)[:, :3])
    for fn in (sampling.random_bits, sampling.uniform_tiny):
        cpu = fn(key, V)
        card = fn(tuple(k.to(cuda) for k in key), V).cpu()
        assert torch.equal(card.view(torch.int32) if card.is_floating_point()
                           else card, cpu.view(torch.int32)
                           if cpu.is_floating_point() else cpu), fn.__name__
    g_cpu = sampling.gumbel(key, V)
    g_card = sampling.gumbel(tuple(k.to(cuda) for k in key), V).cpu()
    unit = torch.maximum(torch.ones_like(g_cpu) * EPS32,
                         g_cpu.abs() * EPS32)
    assert ((g_card - g_cpu).abs() <= GUMBEL_ULPS * unit).all()
    shape = (B, C, V) if C else (B, V)
    logits = torch.from_numpy(rng.standard_normal(shape) * 3).to(
        getattr(torch, dtype))
    temp = torch.tensor([0.0, 1.0, 0.5, 1.0, 0.8, 1.3, 1.0, 2.0])
    top_k = torch.tensor([0, 1, 0, 4, 40, 0, 0, 8], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.9, 0.5, 1.0])
    ops = (temp, top_k, top_p, seeds, index)
    cpu = sampling.sample_tokens(logits, *ops)
    card = sampling.sample_tokens(logits.to(cuda),
                                  *(x.to(cuda) for x in ops)).cpu()
    assert card.dtype == torch.int32 and card.shape == cpu.shape
    lg = logits.reshape(B, -1, V)
    ambiguous = 0
    for b in range(B):
        for c in range(lg.shape[1]):
            a, w = card.reshape(B, -1)[b, c], cpu.reshape(B, -1)[b, c]
            if temp[b] <= 0 or top_k[b] == 1:
                assert a == w == lg[b, c].float().argmax()
            elif a != w:
                gap, mag, kgap, cut = sampling.draw_margins(
                    lg[b, c], sampling.SamplingParams(
                        float(temp[b]), int(top_k[b]), float(top_p[b]),
                        int(seeds[b])), int(index.reshape(B, -1)[b, c]))
                tol = 6 * EPS32 * max(1.0, mag)
                assert gap <= tol or kgap <= tol or cut <= 64 * EPS32, \
                    (b, c, gap, kgap, cut)
                ambiguous += 1
    print(f"{dtype} C={C}: {ambiguous} rows drew another token where the "
          "CPU's draw is ambiguous within the noise's rounding")


def _prefilled(cfg, params, device, *, fp8_kv, B=3, bs=8, MB=8, ctx=13):
    """A pool with `ctx` random tokens of context per slot, written by a
    plain chunk_step, and its block table (all MB blocks allocated)."""
    cache = api.init_cache(cfg, B, MB * bs, block_size=bs,
                           num_blocks=B * MB, device=device, fp8_kv=fp8_kv)
    bt = torch.arange(B * MB, dtype=torch.int32, device=device).reshape(B,
                                                                        MB)
    g = torch.Generator().manual_seed(ctx)
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), generator=g,
                         dtype=torch.int32).to(device)
    pos = torch.zeros(B, dtype=torch.int32, device=device)
    api.chunk_step(cfg, params, cache, toks, pos,
                   torch.full((B,), ctx, dtype=torch.int32, device=device),
                   bt, kernel=False)
    return cache, bt


@pytest.mark.gpu
@pytest.mark.parametrize("fp8_opts", [{}, dict(fp8_kv=True,
                                              fp8_linear=True)],
                         ids=["bf16", "fp8"])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_verify_step_kernel_vs_plain(cuda, fp8_opts, K):
    """verify_step at C = K + 1 through the paged chunk kernel: every
    kernel call within the paged limits of its plain version on the
    same inputs; the tokens equal the gather path's where the plain
    logits' top-2 margin is not small."""
    from repro_torch.te import linear as te_linear
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    quant = (te_linear.quantize_serving_params(params)
             if fp8_opts else None)
    fp8_kv = bool(fp8_opts)
    B, ctx = 3, 13
    cache, bt = _prefilled(cfg, params, cuda, fp8_kv=fp8_kv, B=B, ctx=ctx)
    plain_cache = {k: v.clone() for k, v in cache.items()}
    window = torch.randint(0, cfg.vocab_size, (B, K + 1), dtype=torch.int32,
                           device=cuda)
    pos = torch.tensor([ctx, ctx - 5, 2], dtype=torch.int32, device=cuda)
    calls = []
    orig = transformer._cache_attend

    def checked(q, k1, v1, cl, pos_, positions, block_table, *, decode,
                kernel):
        o = orig(q, k1, v1, cl, pos_, positions, block_table,
                 decode=decode, kernel=kernel)
        if kernel:
            plain = pk.paged_chunk_fp8_plain if fp8_kv else \
                pk.paged_chunk_plain
            kw = ({"k_scale": cl["k_scale"], "v_scale": cl["v_scale"]}
                  if fp8_kv else {})
            want = plain(q, cl["k"], cl["v"], block_table, pos_, **kw)
            calls.append(_paged_err_ok(o, want, "bfloat16"))
        return o

    key = "paged_chunk_fp8" if fp8_kv else "paged_chunk"
    n0 = pk.launch_counts()[key]
    transformer._cache_attend = checked
    try:
        x = transformer._chunk_fwd(cfg, params, cache, window, pos, bt,
                                   kernel=True, quant=quant)
    finally:
        transformer._cache_attend = orig
    torch.cuda.synchronize()
    assert pk.launch_counts()[key] == n0 + cfg.num_layers
    assert len(calls) == cfg.num_layers and all(ok for _, ok in calls), \
        calls
    xp = transformer._chunk_fwd(cfg, params, plain_cache, window, pos, bt,
                                kernel=False, quant=quant)
    lk = transformer.logits_fn(cfg, params, x).float()
    lp = transformer.logits_fn(cfg, params, xp).float()
    preds, _ = api.verify_step(cfg, params, plain_cache, window, pos, bt,
                               kernel=False, quant=quant)
    assert torch.equal(preds, lp.argmax(-1).to(torch.int32))
    top = lp.topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > (0.5 if fp8_kv else 0.0625)
    assert torch.equal(lk.argmax(-1)[clear], lp.argmax(-1)[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("fp8_kv", [False, True], ids=["bf16", "fp8"])
def test_rolled_back_window_is_never_read(cuda, fp8_kv):
    """A verify window that crosses a block boundary, rolled back: what
    its rejected rows wrote past the frontier, and whatever a later
    owner writes into the block that went back to the pool, never
    reaches a later verify.  The next verify's hidden states equal,
    bit for bit, those over a pool that held nothing past the
    frontier."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    B, bs, K, ctx = 3, 8, 4, 14        # the window [14, 18] crosses 16
    clean, bt = _prefilled(cfg, params, cuda, fp8_kv=fp8_kv, B=B, ctx=ctx)
    dirty = {k: v.clone() for k, v in clean.items()}
    pos = torch.full((B,), ctx, dtype=torch.int32, device=cuda)
    window = torch.randint(0, cfg.vocab_size, (B, K + 1), dtype=torch.int32,
                           device=cuda)
    api.verify_step(cfg, params, dirty, window, pos, bt, kernel=True)
    # accept one token: the frontier is ctx + 1; block 2 (positions
    # 16-23) went back to the pool and another slot wrote it
    for leaf in dirty.values():
        blocks = bt[:, 2].long()
        if leaf.is_floating_point() and leaf.element_size() > 1:
            leaf[:, blocks] = 1e4
        else:
            leaf.view(torch.uint8)[:, blocks] = 0x7e
    nxt = torch.randint(0, cfg.vocab_size, (B, K + 1), dtype=torch.int32,
                        device=cuda)
    new_pos = pos + 1
    # the clean pool gets the accepted row only, as a one-row write
    api.verify_step(cfg, params, clean, window[:, :1], pos, bt, kernel=True)
    xd = transformer._chunk_fwd(cfg, params, dirty, nxt, new_pos, bt,
                                kernel=True, quant=None)
    xc = transformer._chunk_fwd(cfg, params, clean, nxt, new_pos, bt,
                                kernel=True, quant=None)
    torch.cuda.synchronize()
    assert torch.equal(xd, xc)


@pytest.mark.gpu
@pytest.mark.parametrize("fp8_opts", [{}, dict(fp8_kv=True,
                                              fp8_linear=True)],
                         ids=["bf16", "fp8"])
def test_spec_server_on_card_launches_only_the_chunk_kernel(cuda, fp8_opts):
    """A spec-decode wave: every verify step and chunk step launches the
    chunk kernel once a layer, the decode kernel never; a second fresh
    server gives the same tokens."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    outs = []
    for _ in range(2):
        srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                                   chunk=8, span=4, block_size=8,
                                   spec_decode=3, device=cuda, **fp8_opts)
        reqs = server.repetitive_requests(6, cfg.vocab_size, motif_len=4,
                                          reps=3, max_output=12, seed=5)
        n0 = srv.launch_counts()
        stats = srv.serve(reqs)
        n1 = srv.launch_counts()
        sfx = "_fp8" if fp8_opts else ""
        assert n1["paged_decode" + sfx] == n0["paged_decode" + sfx]
        assert (n1["paged_chunk" + sfx] - n0["paged_chunk" + sfx]
                == cfg.num_layers * (stats["chunk_steps"]
                                     + stats["spec_steps"]))
        assert all(r.done and len(r.output) == r.max_new for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ----------------------------------------------------------------------
# matrix products: matmul, single_tile_matmul, fp8_matmul,
# pipelined_matmul
# ----------------------------------------------------------------------

def _normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype)


def _ints(rng, shape, device, lo=-16, hi=16):
    return torch.from_numpy(rng.integers(lo, hi, shape)).to(
        device=device, dtype=torch.int8)


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _within_a_bf16_step(got, want):
    got, want = got.float(), want.float()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs()
            + 2.0 ** -12 * want.abs().max()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 256, 128),
                                   (96, 64, 160), (32, 512, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_vs_plain(cuda, m, n, k, dtype):
    rng = np.random.default_rng(7)
    td = getattr(torch, dtype)
    a, b = _normal(rng, (m, k), td, cuda), _normal(rng, (k, n), td, cuda)
    n0 = mmk.matmul.launches
    got = ops.matmul(a, b, bm=32, bn=32, bk=32)
    torch.cuda.synchronize()
    assert mmk.matmul.launches == n0 + 1
    assert got.dtype == td
    bf16 = dtype == "bfloat16"
    _close(got, mmk.matmul_plain(a, b), 2e-2 if bf16 else 1e-5,
           2e-1 if bf16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tiles", [(128, 128, 128), (128, 256, 128),
                                   (64, 64, 64), (256, 512, 64),
                                   (16, 8, 16), (8, 8, 8)])
def test_matmul_tiles_vs_plain(cuda, dtype, tiles):
    """Every tile shape the kernel dispatches on: whole and partial
    warp tiles, a tile walked in several 128 x 256 sub-tiles, and tiles
    below the mma.sync fragment (m16 n8, k16 bf16 / k32 int8)."""
    rng = np.random.default_rng(11)
    M, N, K = 256, 512, 192
    if dtype == "int8":
        a, b = _ints(rng, (M, K), cuda), _ints(rng, (K, N), cuda)
    else:
        td = getattr(torch, dtype)
        a, b = _normal(rng, (M, K), td, cuda), _normal(rng, (K, N), td, cuda)
    bm, bn, bk = tiles
    got = mmk.matmul(a, b, bm=bm, bn=bn, bk=bk)
    want = mmk.matmul_plain(a, b)
    assert got.dtype == want.dtype
    if dtype == "int8":
        assert torch.equal(got, want)
    elif dtype == "bfloat16":
        _within_a_bf16_step(got, want)
    else:
        _close(got, want, 1e-5, 1e-4)


@pytest.mark.gpu
def test_matmul_int8_exact_and_auto_tile(cuda):
    rng = np.random.default_rng(7)
    a, b = _ints(rng, (64, 96), cuda), _ints(rng, (96, 64), cuda)
    got = ops.matmul(a, b, bm=32, bn=32, bk=32)
    assert got.dtype == torch.int32
    assert torch.equal(got, mmk.matmul_plain(a, b))
    a = _normal(rng, (256, 256), torch.float32, cuda)
    b = _normal(rng, (256, 256), torch.float32, cuda)
    _close(ops.matmul(a, b), mmk.matmul_plain(a, b), 1e-4, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("tiles", [(32, 32, 32), (128, 128, 128),
                                   (16, 8, 16)])
def test_fp8_matmul_vs_plain(cuda, fmt, tiles):
    rng = np.random.default_rng(7)
    fd = getattr(torch, fmt)
    M, N, K = (64, 64, 128) if tiles[0] <= 32 else (256, 384, 512)
    aq = torch.from_numpy(rng.standard_normal((M, K))).to(fd).to(cuda)
    bq = torch.from_numpy(rng.standard_normal((K, N))).to(fd).to(cuda)
    sx = torch.tensor(0.37, device=cuda)
    sw = torch.tensor(1.9, device=cuda)
    n0 = f8k.fp8_matmul.launches
    bm, bn, bk = tiles
    got = ops.fp8_matmul(aq, bq, sx, sw, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert f8k.fp8_matmul.launches == n0 + 1
    assert got.dtype == torch.bfloat16
    want = f8k.fp8_matmul_plain(aq, bq, sx, sw)
    _close(got, want, 2e-2, 2e-1)
    _within_a_bf16_step(got, want)


WG_TILES = [(bm, bn, bk) for bm in (64, 128) for bn in (64, 128, 256)
            for bk in (64, 128)]


def _operands(rng, dtype, M, N, K, device):
    if dtype == torch.int8:
        return _ints(rng, (M, K), device), _ints(rng, (K, N), device)
    if dtype.itemsize == 1:
        return (torch.from_numpy(rng.standard_normal((M, K))).to(dtype).to(
            device), torch.from_numpy(rng.standard_normal((K, N))).to(
                dtype).to(device))
    return _normal(rng, (M, K), dtype, device), _normal(rng, (K, N), dtype,
                                                        device)


def _product(dtype, a, b, tiles):
    """The kernel's and the plain version's product, and the body the
    call launched (from the per-body counts)."""
    bm, bn, bk = tiles
    if dtype in f8k.FORMATS:
        sx = torch.tensor(0.37, device=a.device)
        sw = torch.tensor(1.9, device=a.device)
        counts = f8k.fp8_matmul.body_launches
        before = dict(counts)
        got = f8k.fp8_matmul(a, b, sx, sw, bm=bm, bn=bn, bk=bk)
        want = f8k.fp8_matmul_plain(a, b, sx, sw)
    else:
        counts = mmk.matmul.body_launches
        before = dict(counts)
        got = mmk.matmul(a, b, bm=bm, bn=bn, bk=bk)
        want = mmk.matmul_plain(a, b)
    torch.cuda.synchronize()
    ran = [x for x in counts if counts[x] != before[x]]
    assert len(ran) == 1 and counts[ran[0]] == before[ran[0]] + 1
    return got, want, ran[0]


def _agree(dtype, got, want):
    assert got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        _within_a_bf16_step(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", WG_TILES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn, torch.float8_e5m2])
def test_wgmma_body_vs_plain(cuda, dtype, tiles):
    """Every tile of the warpgroup grid (bm 64/128, bn 64/128/256 but
    fp8 at most 128, bk a whole number of 128-byte box rows) runs the
    wgmma body and agrees with the plain version; the others run
    mma_sync and agree too.  The shape is ragged in M and N."""
    rng = np.random.default_rng(3)
    M, N, K = 200, 336, 512
    a, b = _operands(rng, dtype, M, N, K, cuda)
    got, want, ran = _product(dtype, a, b, tiles)
    assert ran == mmk.body(dtype, M, N, K, *tiles)
    assert ran == ("wgmma" if mmk.on_wgmma_grid(dtype, *tiles)
                   else "mma_sync")
    _agree(dtype, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (200, 328, 200)), (torch.bfloat16, (1, 8, 8)),
    (torch.bfloat16, (333, 1000, 1000)), (torch.int8, (200, 330, 208)),
    (torch.int8, (70, 17, 4096)), (torch.float8_e4m3fn, (200, 328, 208)),
    (torch.float8_e5m2, (3, 1000, 144))])
def test_wgmma_body_ragged_edges(cuda, dtype, shape):
    """Ragged M, N and K: TMA's zero fill past the tensor and the masked
    epilogue store (odd N stores element by element)."""
    rng = np.random.default_rng(5)
    a, b = _operands(rng, dtype, *[shape[0], shape[1], shape[2]], cuda)
    for tiles in ((128, 128, 128), (64, 64, 128)):
        got, want, ran = _product(dtype, a, b, tiles)
        assert ran == "wgmma"
        _agree(dtype, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
@pytest.mark.parametrize("tiles", [(128, 128, 128), (128, 64, 256),
                                   (64, 8, 16)])
def test_8_bit_b_contiguous_and_column_major(cuda, dtype, tiles):
    """The 8-bit wrappers take B contiguous (copied K-major inside the
    call for wgmma) or column-major (passed as it is to wgmma, copied
    row-major for mma_sync): the same product either way."""
    rng = np.random.default_rng(9)
    a, b = _operands(rng, dtype, 256, 192, 384, cuda)
    col = b.t().contiguous().t()
    assert col.t().is_contiguous() and not col.is_contiguous()
    got_row, want, ran_row = _product(dtype, a, b, tiles)
    got_col, _, ran_col = _product(dtype, a, col, tiles)
    assert ran_row == ran_col == mmk.body(dtype, 256, 192, 384, *tiles)
    _agree(dtype, got_row, want)
    assert torch.equal(got_row, got_col)


@pytest.mark.gpu
def test_fp8_wgmma_promotion_at_k_4096(cuda):
    """e4m3 at K=4096 on the wgmma body lands within one bf16 step of the
    plain float32 product: each 128 values of K are promoted into the
    float32 accumulator, out of the fp8 wgmma's reduced-precision adder."""
    rng = np.random.default_rng(1)
    a, b = _operands(rng, torch.float8_e4m3fn, 256, 512, 4096, cuda)
    got, want, ran = _product(torch.float8_e4m3fn, a,
                              b.t().contiguous().t(), (128, 128, 128))
    assert ran == "wgmma"
    _within_a_bf16_step(got, want)


RULE_CASES = [      # dtype, (M, N, K), tiles
    (torch.bfloat16, (2048, 11008, 4096), (128, 128, 128)),
    (torch.bfloat16, (200, 330, 200), (128, 128, 64)),
    (torch.bfloat16, (200, 328, 204), (128, 128, 64)),
    (torch.bfloat16, (512, 512, 512), (256, 128, 128)),
    (torch.bfloat16, (512, 512, 512), (128, 128, 320)),
    (torch.int8, (200, 330, 208), (128, 256, 128)),
    (torch.int8, (200, 328, 200), (128, 128, 128)),
    (torch.int8, (512, 512, 512), (128, 128, 64)),
    (torch.float8_e4m3fn, (512, 512, 512), (128, 128, 128)),
    (torch.float8_e5m2, (512, 512, 512), (128, 256, 128)),
    (torch.float8_e4m3fn, (512, 512, 520), (128, 128, 128)),
    (torch.float32, (512, 512, 512), (128, 128, 128)),
    (torch.float32, (2048, 11008, 4096), (64, 64, 64)),
    (torch.float32, (200, 330, 200), (64, 64, 64)),
    (torch.float32, (512, 512, 512), (128, 256, 128)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,tiles", RULE_CASES)
def test_body_rule_python_mirror_matches_the_source(cuda, dtype, shape,
                                                    tiles):
    """`matmul.body` is a mirror of the sources' `matmul_body` and
    `fp8_matmul_body` (aligned and not), and the wgmma body's shared
    memory is the sources' count."""
    for aligned in (1, 0):
        want = mmk.body(dtype, *shape, *tiles, "row", bool(aligned))
        if dtype in f8k.FORMATS:
            code = build.load(f8k.SOURCE).fp8_matmul_body(*shape, *tiles,
                                                          aligned)
        else:
            code = build.load(mmk.SOURCE).matmul_body(
                mmk._DTYPES[dtype], *shape, *tiles, aligned)
        assert mmk.BODIES[code] == want
    if mmk.on_wgmma_grid(dtype, *tiles):
        if dtype in f8k.FORMATS:
            n = build.load(f8k.SOURCE).fp8_matmul_wgmma_smem_bytes(*tiles)
        else:
            n = build.load(mmk.SOURCE).matmul_wgmma_smem_bytes(
                mmk._DTYPES[dtype], *tiles)
        assert n == mmk.smem_bytes(dtype, *tiles, "wgmma") <= mmk.SMEM_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(200, 332, 516), (1, 8, 8),
                                   (333, 1000, 1000), (256, 512, 192)])
@pytest.mark.parametrize("tiles", [(128, 128, 128), (64, 64, 64),
                                   (32, 32, 32), (16, 16, 16),
                                   (128, 64, 32), (16, 128, 8)])
def test_float32_tma_body_vs_plain(cuda, shape, tiles):
    """float32 tiles on the fma_tma grid run the TMA ring at ragged M, N
    and K (TMA's zero fill past the edge) and agree with the plain
    product within rtol 1e-5."""
    rng = np.random.default_rng(4)
    a, b = _operands(rng, torch.float32, *shape, cuda)
    got, want, ran = _product(torch.float32, a, b, tiles)
    assert ran == "fma_tma" == mmk.body(torch.float32, *shape, *tiles)
    _close(got, want, 1e-5, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unaligned", "k_odd", "n_odd", "bn_256"])
def test_float32_off_the_tma_grid_takes_fma(cuda, case):
    """What TMA cannot read, or a tile off its grid, runs the fma body,
    by the rule and not as a fallback, and agrees all the same."""
    rng = np.random.default_rng(6)
    M, N, K = 200, 332, 516
    tiles = (128, 128, 128)
    if case == "k_odd":
        K = 514
    if case == "n_odd":
        N = 330
    if case == "bn_256":
        tiles = (128, 256, 64)
    a, b = _operands(rng, torch.float32, M, N, K, cuda)
    ok = True
    if case == "unaligned":
        buf = _normal(rng, (M * K + 1,), torch.float32, cuda)
        a = buf[1:].view(M, K)
        assert a.data_ptr() % 16
        ok = False
    got, want, ran = _product(torch.float32, a, b, tiles)
    assert ran == "fma" == mmk.body(torch.float32, M, N, K, *tiles, "row",
                                    ok)
    _close(got, want, 1e-5, 1e-4)


@pytest.mark.gpu
def test_misaligned_operand_takes_mma_sync(cuda):
    """A base address off 16 bytes cannot be read by TMA: the rule names
    mma_sync, which the call runs (no fallback after a failure)."""
    rng = np.random.default_rng(2)
    buf = _normal(rng, (256 * 256 + 1,), torch.bfloat16, cuda)
    a = buf[1:].view(256, 256)
    b = _normal(rng, (256, 256), torch.bfloat16, cuda)
    assert a.data_ptr() % 16
    got, want, ran = _product(torch.bfloat16, a, b, (128, 128, 128))
    assert ran == "mma_sync" == mmk.body(torch.bfloat16, 256, 256, 256,
                                         128, 128, 128, "row", False)
    _within_a_bf16_step(got, want)


@pytest.mark.gpu
def test_matmul_wrappers_never_run_the_plain_version_on_cuda(cuda,
                                                             monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("plain version run on a CUDA tensor")
    for mod in (mmk, f8k):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, boom)
    i8 = torch.ones((128, 128), dtype=torch.int8, device=cuda)
    bf = torch.ones((128, 128), dtype=torch.bfloat16, device=cuda)
    q = torch.ones((128, 128), dtype=torch.float8_e4m3fn, device=cuda)
    for tiles in ((128, 128, 128), (32, 32, 32)):
        mmk.matmul(i8, i8, bm=tiles[0], bn=tiles[1], bk=tiles[2])
        mmk.matmul(bf, bf, bm=tiles[0], bn=tiles[1], bk=tiles[2])
        f8k.fp8_matmul(q, q, 1.0, 1.0, bm=tiles[0], bn=tiles[1],
                       bk=tiles[2])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_pipelined_matmul_stages_agree(cuda):
    """stages 1 (one buffer: copy, wait, compute), 2 and 3 (a ring)
    against the plain version within 1e-4 and within 1e-4 of each
    other, at the reference's test case and at 64 x 64 x 64 tiles of a
    longer K (both on the tma body)."""
    rng = np.random.default_rng(7)
    for (M, N, K), t in (((64, 96, 128), 32), ((256, 192, 1024), 64)):
        a = _normal(rng, (M, K), torch.float32, cuda)
        b = _normal(rng, (K, N), torch.float32, cuda)
        want = apk.pipelined_matmul_plain(a, b)
        outs = []
        for stages in (1, 2, 3):
            n0 = apk.pipelined_matmul.launches
            outs.append(ops.pipelined_matmul(a, b, bm=t, bn=t, bk=t,
                                             stages=stages))
            torch.cuda.synchronize()
            assert apk.pipelined_matmul.launches == n0 + 1
            _close(outs[-1], want, 1e-4, 1e-4)
        for o in outs[1:]:
            _close(o, outs[0], 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    ("float32", (64, 64, 64)), ("bfloat16", (64, 64, 64)),
    ("int8", (64, 96, 64)), ("float32", (256, 256, 256)),
    ("bfloat16", (128, 256, 128)), ("int8", (256, 256, 256))])
def test_single_tile_matmul_vs_plain(cuda, dtype, shape):
    """One block over the whole product; 256^3 float32 operands (512 KB)
    are staged in K slices.  Output in the accumulator's dtype."""
    rng = np.random.default_rng(5)
    m, n, k = shape
    if dtype == "int8":
        a, b = _ints(rng, (m, k), cuda, -8, 8), _ints(rng, (k, n), cuda, -8, 8)
    else:
        td = getattr(torch, dtype)
        a, b = _normal(rng, (m, k), td, cuda), _normal(rng, (k, n), td, cuda)
    n0 = mmk.single_tile_matmul.launches
    got = mmk.single_tile_matmul(a, b)
    torch.cuda.synchronize()
    assert mmk.single_tile_matmul.launches == n0 + 1
    want = mmk.single_tile_matmul_plain(a, b)
    assert got.dtype == want.dtype == (torch.int32 if dtype == "int8"
                                       else torch.float32)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        _close(got, want, 1e-4, 1e-4)


PIPE_TILES = [(16, 16, 16), (32, 32, 32), (64, 64, 64), (64, 32, 16),
              (32, 64, 128)]
PIPE_SHAPES = [(200, 136, 520),    # ragged M and N, K % 4 == 0: tma
               (96, 72, 130),      # K * 4 not whole 16 bytes: cp_async
               (64, 66, 96)]       # N * 4 not whole 16 bytes: cp_async


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", PIPE_TILES)
@pytest.mark.parametrize("shape", PIPE_SHAPES)
def test_pipelined_matmul_bodies_vs_plain(cuda, tiles, shape):
    """Every stage count on each body: the body the rule names runs
    (counted by body), each result within 1e-4 of the plain version and
    of the others."""
    rng = np.random.default_rng(4)
    M, N, K = shape
    a = _normal(rng, (M, K), torch.float32, cuda)
    b = _normal(rng, (K, N), torch.float32, cuda)
    want = apk.pipelined_matmul_plain(a, b)
    name = apk.body(M, N, K, *tiles)
    assert name == ("tma" if K % 4 == 0 and N % 4 == 0 else "cp_async")
    outs = []
    for stages in range(1, apk.MAX_STAGES + 1):
        before = dict(apk.pipelined_matmul.body_launches)
        outs.append(apk.pipelined_matmul(a, b, bm=tiles[0], bn=tiles[1],
                                         bk=tiles[2], stages=stages))
        torch.cuda.synchronize()
        after = apk.pipelined_matmul.body_launches
        assert {x: after[x] - before[x] for x in after} == {
            x: int(x == name) for x in after}
        _close(outs[-1], want, 1e-4, 1e-4)
    for o in outs[1:]:
        _close(o, outs[0], 1e-4, 1e-4)


@pytest.mark.gpu
def test_pipelined_matmul_misaligned_operand_takes_cp_async(cuda):
    rng = np.random.default_rng(6)
    buf = _normal(rng, (128 * 256 + 1,), torch.float32, cuda)
    a = buf[1:].view(128, 256)
    b = _normal(rng, (256, 128), torch.float32, cuda)
    assert apk.body(128, 128, 256, 64, 64, 64, aligned=False) == "cp_async"
    before = dict(apk.pipelined_matmul.body_launches)
    got = apk.pipelined_matmul(a, b, bm=64, bn=64, bk=64, stages=2)
    torch.cuda.synchronize()
    assert apk.pipelined_matmul.body_launches["cp_async"] == \
        before["cp_async"] + 1
    _close(got, apk.pipelined_matmul_plain(a, b), 1e-4, 1e-4)


PIPE_RULE = [   # (M, N, K), tiles
    ((2048, 11008, 4096), (64, 64, 64)), ((2048, 11008, 4096), (16, 16, 16)),
    ((128, 64, 128), (32, 32, 32)), ((200, 136, 522), (64, 64, 64)),
    ((200, 138, 520), (64, 64, 64)), ((128, 128, 128), (48, 64, 64)),
    ((128, 128, 128), (64, 64, 8)), ((128, 128, 128), (128, 256, 64)),
    ((64, 16 * 65536, 16), (16, 16, 16)), ((7, 9, 33), (7, 9, 33)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tiles", PIPE_RULE)
def test_pipelined_body_rule_python_mirror_matches_the_source(cuda, shape,
                                                              tiles):
    lib = build.load(apk.SOURCE)
    for aligned in (1, 0):
        code = lib.pipelined_matmul_body(*shape, *tiles, aligned)
        assert apk.BODIES[code] == apk.body(*shape, *tiles, bool(aligned))
    for stages in range(1, apk.MAX_STAGES + 1):
        assert lib.pipelined_matmul_smem_bytes(*tiles, stages) == \
            apk.smem_bytes(*tiles, stages)


TC_MMA = [(dt, shape) for dt in ("float32", "bfloat16", "int8")
          for shape in ((128, 128, 128), (128, 256, 128), (256, 256, 256))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", TC_MMA + [
    ("bfloat16", (200, 264, 200)), ("int8", (136, 48, 384)),
    ("float32", (264, 140, 100)), ("int8", (300, 512, 256)),
    ("bfloat16", (384, 256, 320)), ("float32", (16, 8, 4)),
    ("bfloat16", (256, 128, 1024)), ("int8", (256, 64, 1024)),
    ("float32", (256, 64, 512))])
def test_single_tile_tma_body_vs_plain(cuda, dtype, shape):
    """The nine tc_mma cases and ragged shapes (row blocks, column
    blocks, B kept and streamed) on the tma body: within 1e-4, int8
    exact, counted by body."""
    rng = np.random.default_rng(8)
    m, n, k = shape
    if dtype == "int8":
        a, b = _ints(rng, (m, k), cuda, -128, 128), _ints(rng, (k, n), cuda,
                                                          -128, 128)
    else:
        td = getattr(torch, dtype)
        a, b = _normal(rng, (m, k), td, cuda), _normal(rng, (k, n), td, cuda)
    assert mmk.single_tile_body(a.dtype, m, n, k) == "tma"
    before = dict(mmk.single_tile_matmul.body_launches)
    got = mmk.single_tile_matmul(a, b)
    torch.cuda.synchronize()
    assert mmk.single_tile_matmul.body_launches["tma"] == before["tma"] + 1
    want = mmk.single_tile_matmul_plain(a, b)
    assert got.dtype == want.dtype
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        _close(got, want, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    ("bfloat16", (64, 96, 66)), ("int8", (64, 90, 96)),
    ("float32", (50, 70, 30))])
def test_single_tile_staged_body_vs_plain(cuda, dtype, shape):
    """Operands TMA cannot read (a K or N row off 16 bytes) take the
    staged body, by the rule."""
    rng = np.random.default_rng(9)
    m, n, k = shape
    if dtype == "int8":
        a, b = _ints(rng, (m, k), cuda), _ints(rng, (k, n), cuda)
    else:
        td = getattr(torch, dtype)
        a, b = _normal(rng, (m, k), td, cuda), _normal(rng, (k, n), td, cuda)
    assert mmk.single_tile_body(a.dtype, m, n, k) == "staged"
    before = dict(mmk.single_tile_matmul.body_launches)
    got = mmk.single_tile_matmul(a, b)
    torch.cuda.synchronize()
    assert mmk.single_tile_matmul.body_launches["staged"] == \
        before["staged"] + 1
    want = mmk.single_tile_matmul_plain(a, b)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        _close(got, want, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_single_tile_rule_and_bytes_match_the_source(cuda, dtype):
    lib = build.load(mmk.SOURCE)
    code = mmk._DTYPES[dtype]
    for shape in ((256, 256, 256), (128, 256, 128), (64, 96, 66),
                  (384, 256, 320), (300, 512, 256), (1024, 128, 2048),
                  (64, 90, 96)):
        for aligned in (1, 0):
            assert mmk.SINGLE_BODIES[lib.single_tile_matmul_body(
                code, *shape, aligned)] == mmk.single_tile_body(
                    dtype, *shape, bool(aligned))
        assert lib.single_tile_matmul_smem_bytes(code, *shape) == \
            mmk.single_tile_smem_bytes(dtype, *shape) <= mmk.SMEM_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("box_cols", [32, 16, 8, 4])
@pytest.mark.parametrize("box_rows", [8, 64])
def test_tma_probe_float32_swizzles(cuda, box_rows, box_cols):
    """One TMA load of a float32 box under each swizzle (128B, 64B, 32B,
    none), read back element by element through tma_common.cuh's
    swizzle(): the matrix's corner, exactly (csrc/tma_probe.cu)."""
    import ctypes
    path, _, _ = build.compile_source("tma_probe.cu")
    fn = ctypes.CDLL(str(path)).tma_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    src = torch.arange(100 * 40, dtype=torch.float32, device=cuda).view(
        100, 40)
    out = torch.full((box_rows, box_cols), -1.0, device=cuda)
    err = fn(src.data_ptr(), out.data_ptr(), 100, 40, box_rows, box_cols,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, src[:box_rows, :box_cols])


@pytest.mark.gpu
def test_matmul_shared_memory_limit(cuda):
    """Tiles whose staging exceeds 232448 bytes raise ValueError before
    any launch; the wrappers' byte counts are the sources' own."""
    rng = np.random.default_rng(0)
    a = _normal(rng, (512, 512), torch.float32, cuda)
    n0 = (mmk.matmul.launches, apk.pipelined_matmul.launches)
    with pytest.raises(ValueError, match="shared memory"):
        mmk.matmul(a, a, bm=128, bn=256, bk=512)
    with pytest.raises(ValueError, match="shared memory"):
        apk.pipelined_matmul(a, a, bm=128, bn=128, bk=128, stages=2)
    assert (mmk.matmul.launches, apk.pipelined_matmul.launches) == n0
    lib = build.load(mmk.SOURCE)
    for tiles in [(128, 256, 128), (16, 8, 16), (256, 512, 64), (7, 9, 33)]:
        for dtype, code in mmk._DTYPES.items():
            assert lib.matmul_smem_bytes(code, *tiles) == \
                mmk.smem_bytes(dtype, *tiles)
        assert build.load(f8k.SOURCE).fp8_matmul_smem_bytes(*tiles) == \
            f8k.smem_bytes(*tiles)
        assert build.load(apk.SOURCE).pipelined_matmul_smem_bytes(
            *tiles, 3) == apk.smem_bytes(*tiles, 3)
    for tiles in [(64, 64, 64), (16, 16, 16), (32, 64, 128)]:
        assert build.load(apk.SOURCE).pipelined_matmul_smem_bytes(
            *tiles, 3) == apk.smem_bytes(*tiles, 3, "tma")


@pytest.mark.gpu
def test_dissection_benchmarks_run_on_card(cuda):
    """The five registered benchmarks run on the card through the
    kernels: no failure, every kernel launched, device-labelled rows."""
    from repro_torch.benchmarks import run
    from repro_torch.core import bench
    for mod in (mmk, f8k, apk):
        mod.reset_launch_counts()
    assert bench.run_all(["tc_mma", "tc_wgmma", "tc_n_sweep", "tc_energy",
                          "async_copy"], fail_fast=True, device=cuda) == 0
    counts = {**mmk.launch_counts(), **f8k.launch_counts(),
              **apk.launch_counts()}
    assert all(v > 0 for v in counts.values()), counts
    assert set(bench.registry()) == {"tc_mma", "tc_wgmma", "tc_n_sweep",
                                     "tc_energy", "async_copy",
                                     "dpx_functions", "dpx_kernels", "dsm",
                                     "memory_latency", "memory_throughput",
                                     "te_linear", "te_layer"}
    assert run.main(["tc_energy"]) is None


# ----------------------------------------------------------------------
# DPX (kernels/dpx_kernel.py) and thread-block clusters (kernels/dsm.py)
# ----------------------------------------------------------------------

def _limit_ints(rng, shape, dtype, device):
    """Integers over the whole range of `dtype`, the first few at and
    next to its limits (sums wrap)."""
    info = torch.iinfo(dtype)
    x = rng.integers(info.min, info.max + 1, shape).reshape(-1)
    edge = [info.min, info.max, info.min + 1, info.max - 1, 0, -1, 1,
            info.max // 2, info.min // 2]
    x[:len(edge)] = edge[:x.size]
    return torch.from_numpy(x.reshape(shape)).to(dtype).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", dk.FUNCTIONS)
@pytest.mark.parametrize("dtype", ["int32", "int16"])
@pytest.mark.parametrize("n", [1, 7, 4099, 100003])
def test_dpx_fused_vs_plain(cuda, name, dtype, n):
    """Every fused function, both dtypes, odd lengths (the int16 tail and
    the words past the last 16-byte vector), values at the limits."""
    rng = np.random.default_rng(n)
    td = getattr(torch, dtype)
    a, b, c = (_limit_ints(rng, n, td, cuda) for _ in range(3))
    n0 = dk.dpx_fused.launches
    got = core_dpx.FUSED[name](a, b, c)
    torch.cuda.synchronize()
    assert dk.dpx_fused.launches == n0 + 1
    want = dk.dpx_fused_plain(name, a, b, c)
    assert got.dtype == want.dtype == td
    assert torch.equal(got, want), (name, dtype, n)
    assert torch.equal(got, core_dpx.EMULATED[name](a, b, c))


@pytest.mark.gpu
def test_dpx_fused_rejects_what_the_kernel_does_not_take(cuda):
    x16 = torch.zeros(9, dtype=torch.int16, device=cuda)
    x32 = torch.zeros(8, dtype=torch.int32, device=cuda)
    n0 = dk.dpx_fused.launches
    with pytest.raises(ValueError, match="4-byte"):
        dk.dpx_fused("viaddmax", x16[1:], x16[1:], x16[1:])
    with pytest.raises(ValueError, match="shapes"):
        dk.dpx_fused("viaddmax", x32, x32, x32[:4])
    with pytest.raises(TypeError):
        dk.dpx_fused("vimax3", x32.float(), x32.float(), x32.float())
    with pytest.raises(ValueError, match="unknown"):
        dk.dpx_fused("vimin7", x32, x32, x32)
    assert dk.dpx_fused.launches == n0


def _off16(x):
    """x copied to an address 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    return y


def _counted(fn, kernel, *args, **kwargs):
    """fn(*args) and the body of the one launch it made."""
    n0, by0 = kernel.launches, dict(kernel.launches_by_body)
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    bodies = [k for k, v in kernel.launches_by_body.items() if v != by0[k]]
    assert len(bodies) == 1 and kernel.launches_by_body[bodies[0]] == \
        by0[bodies[0]] + 1
    return got, bodies[0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tiles", [
    ((64, 96, 64), (16, 16, 16)), ((64, 96, 64), (32, 32, 32)),
    ((64, 96, 64), (64, 32, 32)), ((64, 96, 64), (32, 96, 64)),
    ((256, 256, 128), (128, 128, 32)), ((256, 256, 128), (64, 64, 32)),
    ((8, 8, 8), (8, 8, 8)), ((96, 32, 48), (96, 32, 16)),
    # M and N off the tma body's 128 x 128 tile
    ((136, 100, 64), (8, 4, 32)), ((384, 260, 96), (128, 4, 32)),
    # K not a multiple of its 32-deep slice, N % 4 != 0: staged
    ((64, 64, 80), (32, 32, 16)), ((32, 30, 64), (32, 30, 32))])
@pytest.mark.parametrize("values", ["small", "wrap", "floor"])
@pytest.mark.parametrize("offset", [False, True])
def test_tropical_matmul_vs_plain(cuda, shape, tiles, values, offset):
    """Both bodies, each counted where its rule sends the call (A off 16
    bytes takes the staged body); tiles below, at and above the staged
    body's 64 x 64 sub-tile; sums that wrap in int32 and sums under the
    INT_MIN floor."""
    rng = np.random.default_rng(3)
    M, N, K = shape
    lo, hi = {"small": (-50, 50), "wrap": (2 ** 31 - 100, 2 ** 31 - 1),
              "floor": (-2 ** 29 - 200, -2 ** 29 + 50)}[values]
    a = torch.from_numpy(rng.integers(lo, hi, (M, K))).to(torch.int32)
    b = torch.from_numpy(rng.integers(lo, hi, (K, N))).to(torch.int32)
    a, b = a.to(cuda), b.to(cuda)
    if offset:
        a = _off16(a)
    bm, bn, bk = tiles
    got, body = _counted(dk.tropical_matmul, dk.tropical_matmul, a, b,
                         bm=bm, bn=bn, bk=bk)
    assert body == dk.body(M, N, K, not offset)
    if not offset and K % 32 == 0 and N % 4 == 0:
        assert body == "tma"
    want = dk.tropical_matmul_plain(a, b)
    assert torch.equal(got, want)
    if values == "floor":
        assert (want == dk.INT_MIN).any()
    assert torch.equal(ops.tropical_matmul(a, b), want)


@pytest.mark.gpu
def test_tropical_matmul_rejects_and_counts_shared_memory(cuda):
    """The wrapper refuses tiles the reference refuses (on either body)
    and staging past a block's shared memory; the source refuses a body
    its operands do not fit; the shared-memory sizes mirror the
    source's."""
    a = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    n0 = dk.tropical_matmul.launches
    with pytest.raises(ValueError, match="divide"):
        dk.tropical_matmul(a, a, bm=48, bn=32, bk=32)
    with pytest.raises(ValueError, match="exceeds"):
        ops.tropical_matmul(a, a, bm=128)
    big = torch.zeros((64, 512), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        dk.tropical_matmul(big, big.t().contiguous(), bm=64, bn=64, bk=512)
    with pytest.raises(TypeError):
        dk.tropical_matmul(a.float(), a.float())
    assert dk.tropical_matmul.launches == n0
    k48 = torch.zeros((64, 48), dtype=torch.int32, device=cuda)
    out = torch.empty((64, 64), dtype=torch.int32, device=cuda)
    tma = dk.TROPICAL_BODIES.index("tma")
    for x, y, K in ((k48, k48.t().contiguous(), 48),      # 32 does not divide K
                    (_off16(a), a, 64)):                    # A off 16 bytes
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.launch(dk.SOURCE, "tropical_matmul_fwd", cuda,
                         x.data_ptr(), y.data_ptr(), out.data_ptr(), 64, 64,
                         K, 16, 16, 16, tma)
    lib = build.load(dk.SOURCE)
    for tiles in [(32, 32, 32), (16, 8, 16), (128, 256, 64), (7, 9, 33)]:
        assert lib.tropical_smem_bytes(*tiles) == dk.tropical_smem_bytes(
            *tiles)
    for la, lb in [(256, 256), (1500, 1100), (1, 1), (40, 8), (257, 300),
                   (30000, 30000)]:
        p = dk.smith_waterman_plan(la, lb)
        assert lib.smith_waterman_smem_bytes(p.warps) == p.smem_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("B,la,lb", [(2, 16, 16), (4, 24, 20), (1, 40, 8),
                                     (3, 7, 31), (5, 1, 1), (3, 300, 2),
                                     (2, 1500, 1100), (1, 1100, 1500),
                                     (64, 256, 256),
                                     # band edges: Lb of 255, 256, 257,
                                     # 513; La of 1 and 2
                                     (3, 300, 255), (3, 300, 256),
                                     (3, 300, 257), (2, 600, 513),
                                     (2, 1, 300), (2, 2, 257), (2, 513, 2),
                                     (1, 1, 513)])
@pytest.mark.parametrize("scores", [(2, -1, -1), (3, -2, -2), (1, 0, 1)])
def test_smith_waterman_vs_plain(cuda, B, la, lb, scores):
    """Any lengths, on the body the plan names (one band a warp, or
    bands handed on through the scratch edge), non-default scores (a
    positive gap too); the sequences swapped give the same scores."""
    rng = np.random.default_rng(B * la + lb)
    sa = torch.from_numpy(rng.integers(0, 4, (B, la))).to(torch.int32)
    sb = torch.from_numpy(rng.integers(0, 4, (B, lb))).to(torch.int32)
    sa, sb = sa.to(cuda), sb.to(cuda)
    match, mismatch, gap = scores
    kw = dict(match=match, mismatch=mismatch, gap=gap)
    got, body = _counted(ops.smith_waterman, dk.smith_waterman, sa, sb, **kw)
    assert body == dk.smith_waterman_plan(la, lb).body
    want = dk.smith_waterman_plain(sa, sb, **kw)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert torch.equal(got, want)
    assert torch.equal(dk.smith_waterman(sb, sa, **kw), got)
    if B == 1 and la <= 40:
        H = core_dpx.smith_waterman(sa[0], sb[0], **kw)
        assert int(got[0]) == int(H.max())


@pytest.mark.gpu
def test_smith_waterman_rejects(cuda):
    """Refused: a batch mismatch, other dtypes.  Taken: a pair past the
    old shared-memory cap (La + 4 Lb above ~58000)."""
    s = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    n0 = dk.smith_waterman.launches
    with pytest.raises(ValueError, match="shapes"):
        dk.smith_waterman(s, s[:1])
    with pytest.raises(TypeError):
        dk.smith_waterman(s.long(), s.long())
    assert dk.smith_waterman.launches == n0
    got = dk.smith_waterman(s, s[:, :1].repeat(1, 20000))
    assert got.tolist() == [2 * 8, 2 * 8]        # eight matches in a row
    # the source refuses a plan it cannot run: S off 1/2/4/8, several
    # bands on one warp or without the edge scratch, too many warps
    out = torch.empty(2, dtype=torch.int32, device=cuda)
    edge = torch.empty(2 * 8, dtype=torch.int32, device=cuda)
    for S, warps, pairs, e, cols in ((3, 1, 1, None, 8), (0, 1, 1, None, 8),
                                     (1, 1, 1, edge, 40), (1, 2, 1, None, 40),
                                     (8, 17, 1, edge, 8), (8, 1, 17, None, 8),
                                     (8, 2, 2, edge, 8)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.launch(dk.SOURCE, "smith_waterman_fwd", cuda, s.data_ptr(),
                         s.data_ptr(), out.data_ptr(),
                         e.data_ptr() if e is not None else None, 2, 8,
                         cols, S, warps, pairs, 2, -1, -1)


@pytest.mark.gpu
def test_smith_waterman_30000_identical_pair(cuda):
    """A 30000 x 30000 pair of identical sequences scores match x 30000
    (the diagonal, every cell a match); 118 bands on 16 warps."""
    rng = np.random.default_rng(30000)
    x = torch.from_numpy(rng.integers(0, 4, (1, 30000))).to(torch.int32)
    x = x.to(cuda)
    got, body = _counted(dk.smith_waterman, dk.smith_waterman, x, x.clone())
    assert body == "bands"
    assert got.tolist() == [2 * 30000]
    got = dk.smith_waterman(x, x.clone(), match=3, mismatch=-2, gap=-2)
    assert got.tolist() == [3 * 30000]


@pytest.mark.gpu
def test_smith_waterman_beyond_the_old_cap_vs_plain(cuda):
    """Random pairs that PR 14's kernel refused (La + 4 Lb = 60000 and
    62000) against the plain version."""
    rng = np.random.default_rng(14000)
    for la, lb in ((4000, 14000), (14000, 12000)):
        sa = torch.from_numpy(rng.integers(0, 4, (2, la))).to(torch.int32)
        sb = torch.from_numpy(rng.integers(0, 4, (2, lb))).to(torch.int32)
        sa, sb = sa.to(cuda), sb.to(cuda)
        got, body = _counted(dk.smith_waterman, dk.smith_waterman, sa, sb)
        assert body == "bands"
        assert torch.equal(got, dk.smith_waterman_plain(sa, sb))


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("ilp", [1, 2, 4, 8])
def test_rbc_ring_copy_vs_plain(cuda, cs, ilp):
    """Every hop count (a one-block ring: 0-3 hops of itself), a shard
    not a multiple of the tile; float32 bitwise (the kernel adds in the
    plain version's order)."""
    rng = np.random.default_rng(cs * 10 + ilp)
    x = torch.from_numpy(rng.standard_normal((2 * cs, 1000 * 8)) * 1e3).to(
        torch.float32).to(cuda)
    for hops in range(cs if cs > 1 else 4):
        n0 = dsk.rbc_ring_copy.launches
        got = core_dsm.rbc_ring_copy(x, cs, hops=hops, ilp=ilp)
        torch.cuda.synchronize()
        assert dsk.rbc_ring_copy.launches == n0 + 1
        want = dsk.rbc_ring_copy_plain(x, cs, hops=hops)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (cs, hops, ilp)


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_rbc_ring_copy_int32_vs_plain(cuda, cs):
    """int32 rings, sums that wrap at the type's limits: equal at every
    ILP and the most hops."""
    rng = np.random.default_rng(cs)
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2 * cs, 8000))).to(
        torch.int32)
    x[:, :4] = torch.iinfo(torch.int32).max
    x = x.to(cuda)
    hops = max(cs - 1, 3 if cs == 1 else 0)
    for ilp in (1, 2, 4, 8):
        n0 = dsk.rbc_ring_copy.launches
        got = core_dsm.rbc_ring_copy(x, cs, hops=hops, ilp=ilp)
        torch.cuda.synchronize()
        assert dsk.rbc_ring_copy.launches == n0 + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, dsk.rbc_ring_copy_plain(x, cs, hops=hops)), \
            (cs, ilp)


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_ring_latency_probe_and_all_to_all(cuda, cs):
    got = core_dsm.ring_latency_probe(cs, device=cuda)
    want = torch.arange(cs, dtype=torch.int32).roll(1).reshape(cs, 1)
    assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(cs)
    for shape in [(cs * 3, cs * 100), (cs, cs * 257)]:
        x = torch.from_numpy(rng.standard_normal(shape)).float().to(cuda)
        n0 = dsk.all_to_all_exchange.launches
        got = core_dsm.all_to_all_exchange(x, cs)
        torch.cuda.synchronize()
        assert dsk.all_to_all_exchange.launches == n0 + 1
        assert torch.equal(got, dsk.all_to_all_exchange_plain(x, cs))


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nbins", [64, 1024, 4096])
def test_histograms_vs_plain(cuda, cs, nbins):
    """Both histograms equal the plain counts (values outside [0, nbins)
    are not counted by either)."""
    rng = np.random.default_rng(nbins + cs)
    v = rng.integers(0, nbins, cs * 40009)
    v[:3] = [-1, nbins, nbins + 5]
    vals = torch.from_numpy(v).to(torch.int32).to(cuda)
    want = dsk.histogram_private_plain(vals, nbins, cs)
    assert int(want.sum()) == vals.numel() - 3
    for fn in (core_dsm.histogram_private_psum, core_dsm.histogram_dsm):
        got = fn(vals, nbins, cs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    assert torch.equal(dsk.histogram_dsm_plain(vals, nbins, cs), want)


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [2, 4, 8, 16])
def test_histogram_dsm_where_a_private_one_does_not_fit(cuda, cs):
    """65536 bins: a whole histogram (256 KiB) exceeds a block's shared
    memory, the cluster's share of it (256/CS KiB) does not."""
    nbins = 1 << 16
    rng = np.random.default_rng(cs)
    vals = torch.from_numpy(rng.integers(0, nbins, cs * 50021)).to(
        torch.int32).to(cuda)
    got = core_dsm.histogram_dsm(vals, nbins, cs)
    torch.cuda.synchronize()
    assert torch.equal(got, dsk.histogram_dsm_plain(vals, nbins, cs))
    with pytest.raises(ValueError, match="shared memory"):
        core_dsm.histogram_private_psum(vals, nbins, cs)


@pytest.mark.gpu
def test_dsm_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((6, 8), device=cuda)
    counts = dsk.launch_counts()
    with pytest.raises(ValueError, match="row blocks"):
        dsk.rbc_ring_copy(x, 4)
    with pytest.raises(ValueError, match="cluster_size"):
        dsk.rbc_ring_copy(x, 3)
    with pytest.raises(ValueError, match="hops"):
        dsk.rbc_ring_copy(x, 2, hops=2)
    with pytest.raises(ValueError, match="ilp"):
        dsk.rbc_ring_copy(x[:, :6], 2, ilp=4)
    with pytest.raises(ValueError, match="cluster_size"):
        dsk.rbc_ring_copy(torch.zeros((32, 8), device=cuda), 32)
    with pytest.raises(ValueError, match="ilp"):
        dsk.rbc_ring_copy(x, 2, ilp=16)
    with pytest.raises(TypeError):
        dsk.rbc_ring_copy(x.double(), 2)
    with pytest.raises(TypeError):
        dsk.rbc_ring_copy(x.long(), 2)
    vals = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="split evenly"):
        dsk.histogram_dsm(vals, 100, 8)
    with pytest.raises(ValueError, match="shared memory"):
        dsk.histogram_private(vals, 100000, 4)
    with pytest.raises(ValueError, match="pieces"):
        dsk.all_to_all_exchange(torch.zeros((4, 3), device=cuda), 4)
    assert dsk.launch_counts() == counts


@pytest.mark.gpu
def test_clusters_of_16_fit_and_a_cluster_that_does_not_is_refused(
        cuda, monkeypatch):
    """Every cluster kernel launches clusters of 16 on the card at the
    shared memory it uses; where the source finds none fits
    (cudaOccupancyMaxActiveClusters) it refuses the launch, and the
    wrapper raises ValueError and counts nothing."""
    x = torch.ones((16, 4096), device=cuda)
    i32 = torch.ones(16 * 4096, dtype=torch.int32, device=cuda)
    counts = dsk.launch_counts()
    dsk.rbc_ring_copy(x, 16, hops=15, ilp=8)
    dsk.rbc_ring_copy(x.int(), 16, hops=15, ilp=8)
    dsk.ring_latency_probe(torch.zeros((16, 1), dtype=torch.int32,
                                       device=cuda))
    dsk.histogram_private(i32, 4096, 16)
    dsk.histogram_dsm(i32, 65536, 16)
    dsk.all_to_all_exchange(x, 16)
    torch.cuda.synchronize()
    after = dsk.launch_counts()
    assert after["rbc_ring_copy"] == counts["rbc_ring_copy"] + 2
    assert all(after[k] == counts[k] + 1 for k in (
        "ring_latency_probe", "histogram_private", "histogram_dsm",
        "all_to_all_exchange"))
    real = build.load(dsk.SOURCE)

    class Refusing:                # the source's answer where none fits
        def __getattr__(self, name):
            fn = getattr(real, name)
            return lambda *a: 9 if name.endswith("_fwd") else fn(*a)

    monkeypatch.setattr(build, "load", lambda source: Refusing())
    with pytest.raises(ValueError, match="no cluster of 16 blocks"):
        dsk.rbc_ring_copy(x, 16)
    with pytest.raises(ValueError, match="no cluster of 16 blocks"):
        dsk.histogram_dsm(i32, 1024, 16)
    with pytest.raises(build.LaunchError):    # a portable size: no mapping
        dsk.rbc_ring_copy(x, 8)
    assert dsk.launch_counts() == after


@pytest.mark.gpu
def test_wrappers_never_run_the_plain_version_on_cuda(cuda, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("plain version run on a CUDA tensor")
    for mod in (dk, dsk):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, boom)
    i32 = torch.ones((64, 64), dtype=torch.int32, device=cuda)
    dk.dpx_fused("viaddmax", i32, i32, i32)
    dk.tropical_matmul(i32, i32)
    dk.smith_waterman(i32[:2], i32[:2])
    x = torch.ones((4, 64), device=cuda)
    dsk.rbc_ring_copy(x, 4, hops=3, ilp=4)
    dsk.ring_latency_probe(torch.zeros((4, 1), dtype=torch.int32,
                                       device=cuda))
    dsk.histogram_private(i32.reshape(-1), 64, 4)
    dsk.histogram_dsm(i32.reshape(-1), 64, 4)
    dsk.all_to_all_exchange(x, 4)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_dpx_and_dsm_benchmarks_run_on_card(cuda):
    from repro_torch.benchmarks import run  # noqa: F401  (registers)
    from repro_torch.core import bench
    dk.reset_launch_counts()
    dsk.reset_launch_counts()
    assert bench.run_all(["dpx_functions", "dpx_kernels", "dsm"],
                         fail_fast=True, device=cuda) == 0
    counts = {**dk.launch_counts(), **dsk.launch_counts()}
    assert all(v > 0 for v in counts.values()), counts


# ----------------------------------------------------------------------
# flash attention (B9) and the training path
# ----------------------------------------------------------------------

FLASH_CASES = [   # chip_smoke.py phase 10(a), at small sizes
    # dtype      B   Sq   Sk   H  KH  hd causal window q_offset
    ("float32",  2, 128, 128,  8,  2, 32, True,   0,   0),
    ("float32",  1, 128, 128,  4,  4, 64, True,   0,   0),
    ("float32",  2, 256, 256,  8,  1, 32, False,  0,   0),
    ("float32",  1,  64,  64,  6,  3, 16, True,   0,   0),
    ("bfloat16", 1, 128, 128,  4,  2, 32, True,   0,   0),
    ("bfloat16", 2, 512, 512, 32,  4, 128, True,  0,   0),   # yi-6b heads
    ("bfloat16", 2, 256, 256, 12, 12, 64, True,   0,   0),   # llama-te-mini
    ("bfloat16", 1, 300, 300,  8,  2, 128, True, 64,   0),   # window
    ("float32",  1, 300, 300,  8,  2, 64, True,  64,   0),
    ("bfloat16", 1, 333, 333,  8,  2, 64, True,   0,   0),   # ragged
    ("bfloat16", 2, 100, 356,  8,  4, 32, True,   0, 256),   # q_offset
    ("float32",  2, 100, 356,  8,  4, 32, True,   0, 256),
    ("float32",  1,  50,  70,  4,  2, 16, False,  5, 100),   # no valid key
    ("bfloat16", 1,  50,  70,  4,  2, 16, False,  5, 100),
    # the wgmma body (bf16, hd 64 / 128): no valid key, GQA non-causal,
    # a ragged window with q_offset, rows past several 128-row tiles
    ("bfloat16", 1,  50,  70,  4,  2, 64, False,  5, 100),
    ("bfloat16", 1,  64,  96,  4,  2, 128, False, 8, 128),
    ("bfloat16", 2, 200, 200,  8,  2, 64, False,  0,   0),
    ("bfloat16", 2, 130, 390,  8,  2, 128, True, 100, 260),
    ("bfloat16", 1, 700, 700,  8,  1, 64, True, 100,   0),
    # multi-head at head_dim 128: te_transformer_layer's attention
    ("bfloat16", 2, 512, 512, 16, 16, 128, True,  0,   0),
    # head_dim 80: bf16 on mma_sync, float32 on fma
    ("bfloat16", 2, 333, 333,  8,  2, 80, True,   0,   0),
    ("bfloat16", 1, 300, 300,  8,  2, 80, True,  64,   0),
    ("bfloat16", 2, 100, 356,  8,  4, 80, True,   0, 256),
    ("float32",  2, 333, 333,  8,  2, 80, True,   0,   0),
    ("float32",  1, 100, 356,  8,  4, 80, True,  64, 256),
    ("bfloat16", 1,  50,  70,  4,  2, 80, False,  5, 100),
]


def _flash_inputs(dtype, B, Sq, Sk, H, KH, hd, device, seed=0):
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    return tuple(torch.from_numpy(rng.standard_normal(shape)).to(device, td)
                 for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                               (B, Sk, KH, hd), (B, Sq, H, hd)))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,B,Sq,Sk,H,KH,hd,causal,window,q_offset", FLASH_CASES)
def test_flash_attention_vs_plain(cuda, dtype, B, Sq, Sk, H, KH, hd, causal,
                                  window, q_offset):
    q, k, v, _ = _flash_inputs(dtype, B, Sq, Sk, H, KH, hd, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n0 = kfa.launch_counts()["flash_attention"]
    b0 = kfa.body_launches()
    o, lse = kfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kfa.launch_counts()["flash_attention"] == n0 + 1
    b1 = kfa.body_launches()
    name = kfa.body(q.dtype, hd)
    assert {x: b1[x] - b0[x] for x in b1} == \
        {x: int(x == name) for x in kfa.BODIES}
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, **kw)
    assert o.dtype == q.dtype and lse.shape == (B, H, Sq)
    err = (o.float() - po.float()).abs().max().item()
    if dtype == "float32":
        assert err <= 1e-4, err
    else:
        assert err <= 2.0 ** -7 * po.float().abs().max().item(), err
    lse_err = (lse - plse).abs().max() / plse.abs().max().clamp(min=1.0)
    assert lse_err.item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_flash_attention_grads_kernel_vs_plain_forward(cuda, dtype, causal,
                                                       window, monkeypatch):
    """dq, dk, dv of models/attention.flash_attention with the kernel
    forward against the same function with the plain forward."""
    q, k, v, do = _flash_inputs(dtype, 2, 640, 640, 8, 2, 128, cuda, seed=1)
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def grads():
        out = attention.flash_attention(*leaves, causal=causal,
                                        window=window)
        return torch.autograd.grad(out, leaves, do)

    got = grads()
    monkeypatch.setattr(kfa, "flash_attention_fwd",
                        kfa.flash_attention_fwd_plain)
    want = grads()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == q.dtype
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= (1e-4 if dtype == "float32" else 2.0 ** -5 * top), \
            (err, top)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [("bfloat16", 64), ("bfloat16", 80),
                                      ("float32", 80)])
def test_flash_attention_grads_through_each_body(cuda, dtype, hd,
                                                 monkeypatch):
    """Gradients with the wgmma (bf16 hd 64) and the head_dim-80 bodies'
    forward against the plain forward, GQA, causal and a window."""
    q, k, v, do = _flash_inputs(dtype, 2, 300, 300, 8, 2, hd, cuda, seed=2)
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def grads():
        out = attention.flash_attention(*leaves, causal=True, window=200)
        return torch.autograd.grad(out, leaves, do)

    b0 = kfa.body_launches()
    got = grads()
    assert kfa.body_launches()[kfa.body(q.dtype, hd)] == \
        b0[kfa.body(q.dtype, hd)] + 1
    monkeypatch.setattr(kfa, "flash_attention_fwd",
                        kfa.flash_attention_fwd_plain)
    want = grads()
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= (1e-4 if dtype == "float32" else 2.0 ** -5 * top), \
            (err, top)


@pytest.mark.gpu
def test_flash_attention_body_rule_matches_the_source(cuda):
    """`flash_attention.body` is a mirror of the source's
    `flash_attention_body`; the wrapper counts each launch on its body."""
    lib = build.load(kfa.SOURCE)
    for dtype, code in kfa._DTYPES.items():
        for hd in kfa.HEAD_DIMS:
            assert kfa.BODIES[lib.flash_attention_body(code, hd)] == \
                kfa.body(dtype, hd)
    kfa.reset_launch_counts()
    for dtype, hd in (("bfloat16", 128), ("bfloat16", 64), ("bfloat16", 32),
                      ("float32", 80), ("bfloat16", 128)):
        q, k, v, _ = _flash_inputs(dtype, 1, 70, 70, 4, 2, hd, cuda)
        kfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert kfa.body_launches() == {"wgmma": 3, "mma_sync": 1, "fma": 1}
    assert kfa.launch_counts() == {"flash_attention": 5}


@pytest.mark.gpu
def test_flash_attention_never_runs_plain_on_cuda(cuda, monkeypatch):
    from repro_torch.kernels import ops as kops

    def boom(*args, **kwargs):
        raise AssertionError("plain version run on a CUDA tensor")
    monkeypatch.setattr(kfa, "flash_attention_fwd_plain", boom)
    monkeypatch.setattr(kfa, "flash_attention_plain", boom)
    monkeypatch.setattr(attention, "_attn_fwd", boom)
    q, k, v, do = _flash_inputs("bfloat16", 1, 128, 128, 4, 2, 64, cuda)
    n0 = kfa.launch_counts()["flash_attention"]
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = attention.flash_attention(*leaves, causal=True)
    torch.autograd.grad(out, leaves, do)
    kfa.flash_attention(q.detach(), k.detach(), v.detach())
    kops.flash_attention(q.detach(), k.detach(), v.detach(), bq=64, bk=64)
    torch.cuda.synchronize()
    assert kfa.launch_counts()["flash_attention"] == n0 + 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_more_than_65535_query_heads(cuda, dtype):
    """B*H = 2 * 40000 query heads: past grid.y's 65535, on grid.x."""
    q, k, v, _ = _flash_inputs(dtype, 2, 3, 5, 40000, 40000, 16, cuda)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=True, q_offset=2)
    torch.cuda.synchronize()
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, causal=True,
                                             q_offset=2)
    err = (o.float() - po.float()).abs().max().item()
    limit = 1e-4 if dtype == "float32" else \
        2.0 ** -7 * po.float().abs().max().item()
    assert err <= limit, err
    assert ((lse - plse).abs().max() / plse.abs().max().clamp(min=1.0)
            ).item() <= 1e-4


@pytest.mark.gpu
def test_flash_attention_rejects(cuda):
    q = torch.zeros((1, 16, 4, 24), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention_fwd(q, q[:, :, :2], q[:, :, :2])
    h = torch.zeros((1, 16, 4, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtypes"):
        kfa.flash_attention_fwd(h, h[:, :, :2], h[:, :, :2])
    x = torch.zeros((1, 16, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="non-negative"):
        kfa.flash_attention_fwd(x, x[:, :, :2], x[:, :, :2], window=-1)
    with pytest.raises(ValueError, match="positive"):
        kfa.flash_attention_fwd(x, x[:, :, :2], x[:, :, :2], kv_chunk=0)


@pytest.mark.gpu
def test_trainer_on_card_restarts_bit_exact(cuda, tmp_path):
    """The reduced yi-6b (remat dots) through the port's Trainer on the
    card: a failure after step 3 and a restart from the step-2
    checkpoint give the losses of an uninterrupted run bit for bit; every step
    launches B9 twice a layer (forward + remat recompute)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.runtime.trainer import Trainer
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2,
                              remat="dots")
    runs = []
    for i, fail_at in enumerate((3, None)):
        tcfg = TrainConfig(total_steps=20, warmup_steps=2, ckpt_every=2,
                           ckpt_dir=str(tmp_path / str(i)),
                           learning_rate=1e-3)
        tr = Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, 4, 64),
                     fail_at_step=fail_at, device=cuda)
        tr.init()
        kfa.reset_launch_counts()
        hist = tr.run(6)
        runs.append(([(m.step, m.loss) for m in hist], kfa.launch_counts(),
                     tr.restarts))
    (a, la, ra), (b, lb, rb) = runs
    assert (ra, rb) == (1, 0)
    # the failing run records step 3 twice (before the failure and
    # after the restart from step 2): both times the same loss
    assert [s for s, _ in a] == [1, 2, 3, 3, 4, 5, 6]
    assert dict(a) == dict(b) and a[2] == a[3]
    assert all(np.isfinite([loss for _, loss in b]))
    assert lb["flash_attention"] == 6 * 2 * cfg.num_layers


# ----------------------------------------------------------------------
# memory hierarchy (Tables IV, V) and the Transformer Engine slice
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("size", [4096, 16 << 10, 200 << 10])
def test_pchase_walks_the_chain_on_card(cuda, size):
    nxt = memk.pointer_chain(size)
    chain = torch.tensor(nxt, device=cuda)
    loads = ("ca", "cg", "shared") if size <= memk.SHARED_CHAIN_BYTES \
        else ("ca", "cg")
    for load in loads:
        for warm, iters in ((0, 1), (len(nxt), 999), (5, 4096)):
            before = memk.pchase.launches
            got = memk.pchase(chain, load, iters=iters, warm=warm).cpu()
            want = memk.pchase_plain(chain.cpu(), warm, iters)
            assert memk.pchase.launches == before + 1
            assert int(got[0]) == int(want[0]), (load, warm, iters)
            assert int(got[1]) > 0 and int(got[2]) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,passes", [(4099, 1), (1 << 20, 3), (5, 2)])
def test_stream_bitwise_on_card(cuda, n, passes):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)
                         .astype(np.float32) * 1e3).to(cuda)
    y = memk.stream(x, passes)
    assert torch.equal(y.view(torch.int32),
                       memk.stream_plain(x).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(memk.BW_MODES))
def test_onchip_bw_checksums_on_card(cuda, mode):
    src = torch.randint(-2 ** 31, 2 ** 31 - 1, (memk.BW_WORDS,),
                        dtype=torch.int32, device=cuda)
    for reps in (8, 64):
        sums, cycles = memk.onchip_bw(src, mode, reps=reps)
        want, _ = memk.onchip_bw_plain(src, reps, sums.numel())
        assert torch.equal(sums.cpu(), want)
        assert (cycles > 0).all()
    assert sums.numel() == torch.cuda.get_device_properties(
        cuda).multi_processor_count


def _fp8_codes(shape, fmt, seed, device):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32) * 20)
    return x.to(fmt).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(66, 256, 512), (33, 40, 24), (5, 7, 3),
                                   (128, 80, 48)])
@pytest.mark.parametrize("fx,fw", [("e4m3", "e4m3"), ("e5m2", "e4m3"),
                                   ("e4m3", "e5m2")])
def test_fp8_dot_any_shape_and_mixed_formats(cuda, M, K, N, fx, fw):
    fmts = {"e4m3": fp8.E4M3, "e5m2": fp8.E5M2}
    xq = _fp8_codes((M, K), fmts[fx], M * K, cuda)
    wq = _fp8_codes((K, N), fmts[fw], K * N + 1, cuda)
    sx, sw = (torch.tensor(v, device=cuda) for v in (0.013, 0.7))
    for out_dtype in (torch.float32, torch.bfloat16):
        for w in (wq, wq.t().contiguous().t()):    # row- and column-major
            got = fp8.fp8_dot(xq, sx, w, sw, out_dtype)
            want = fp8.fp8_dot(xq.cpu(), sx.cpu(), w.cpu(), sw.cpu(),
                               out_dtype)
            assert got.shape == (M, N) and got.dtype == out_dtype
            top = want.float().abs().max()
            step = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
            lim = step * want.float().abs() + 2.0 ** -8 * top
            assert ((got.float().cpu() - want.float()).abs() <= lim).all()


@pytest.mark.gpu
def test_te_linear_forward_backward_on_card_vs_cpu(cuda):
    from repro_torch.te import linear
    recipe = fp8.DelayedScalingRecipe()
    rng = np.random.default_rng(24)
    w = torch.from_numpy((rng.standard_normal((256, 512)) / 16)
                         .astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((33, 2, 256)) * s).to(
        torch.bfloat16) for s in (1.0, 3.0)]
    g = torch.from_numpy(rng.standard_normal((33, 2, 512))).to(
        torch.bfloat16)
    outs = []
    for dev in ("cpu", cuda):
        st = linear.init_state(recipe, dev)
        _, st = linear.te_linear({"w": w.to(dev)}, st, xs[0].to(dev), recipe)
        x = xs[1].to(dev).detach().clone().requires_grad_()
        wg = w.to(dev).detach().clone().requires_grad_()
        y, new = linear.te_linear({"w": wg}, st, x, recipe)
        y.backward(g.to(dev))
        outs.append((y.detach().cpu(), x.grad.cpu(), wg.grad.cpu(),
                     {t: {f: v.cpu() for f, v in new[t].items()}
                      for t in new},
                     fp8.quantize(x.detach(), st["x"]["scale"]).cpu()))
    (y0, dx0, dw0, st0, xq0), (y1, dx1, dw1, st1, xq1) = outs
    assert torch.equal(xq0.view(torch.uint8), xq1.view(torch.uint8))
    for t in st0:
        for f in st0[t]:
            assert torch.equal(st0[t][f], st1[t][f]), (t, f)
    for want, got, step in ((y0, y1, 2.0 ** -7), (dx0, dx1, 2.0 ** -7),
                            (dw0, dw1, 0.0)):
        a, b = want.float(), got.float()
        lim = step * a.abs() + 2.0 ** -8 * a.abs().max()
        assert ((a - b).abs() <= lim).all()


@pytest.mark.gpu
def test_te_transformer_layer_on_card_syncs_not(cuda):
    from repro_torch.configs.llama_te import te_layer_config
    from repro_torch.models.common import init_params
    from repro_torch.te import layer
    cfg = te_layer_config(1024)
    recipe = fp8.DelayedScalingRecipe()
    params = init_params(layer.transformer_layer_specs(cfg),
                         torch.Generator(device=cuda).manual_seed(0), cuda,
                         torch.float32)
    state = layer.transformer_layer_state(cfg, recipe, cuda)
    x = torch.randn((2, 200, 1024), device=cuda).to(torch.bfloat16)
    _, state = layer.te_transformer_layer(cfg, params, state, x, recipe)
    torch.cuda.synchronize()
    kfa.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, new = layer.te_transformer_layer(cfg, params, state, x, recipe)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(y.float()).all() and y.shape == x.shape
    assert kfa.launch_counts()["flash_attention"] == 1
    assert kfa.body_launches()["wgmma"] == 1
    hist = new["mlp"]["down"]["x"]["history"]
    assert (hist[:2] > 0).all() and not hist[2:].any()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_te_transformer_layer_card_vs_cpu(cuda):
    """The second call from a fresh state, card against the port on the
    CPU on the same weights and input: weight histories bitwise, the
    output nearer the CPU's than the CPU's is to the bf16 layer_fwd on
    the same weights (the fp8 bar of tests/test_torch_te.py)."""
    from repro_torch.configs.llama_te import te_layer_config
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params
    from repro_torch.te import layer
    cfg = te_layer_config(1024)
    recipe = fp8.DelayedScalingRecipe()
    params = init_params(layer.transformer_layer_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    B, S = 2, 200
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, 1024))).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        st = layer.transformer_layer_state(cfg, recipe, dev)
        _, st = layer.te_transformer_layer(cfg, p, st, x.to(dev), recipe)
        y, st = layer.te_transformer_layer(cfg, p, st, x.to(dev), recipe)
        out[dev] = (y.float().cpu(), st)
    d, H, hd = 1024, cfg.num_heads, cfg.head_dim
    lp = {"ln1": params["ln1"], "ln2": params["mlp"]["ln"],
          "attn": {n: params[n]["w"].reshape(d, H, hd)
                   for n in ("wq", "wk", "wv")},
          "mlp": {"w_up": params["mlp"]["up"]["w"],
                  "w_gate": params["mlp"]["gate"]["w"],
                  "w_down": params["mlp"]["down"]["w"]}}
    lp["attn"]["wo"] = params["wo"]["w"].reshape(H, hd, d)
    bf16, _ = transformer.layer_fwd(cfg, lp, x, torch.arange(S).expand(B, S))
    want, got = out["cpu"][0], out[cuda][0]
    assert (got - want).abs().max() < (want - bf16.float()).abs().max()
    for t in ("wq", "wk", "wv", "wo"):
        assert torch.equal(out[cuda][1][t]["w"]["history"].cpu(),
                           out["cpu"][1][t]["w"]["history"])


@pytest.mark.gpu
def test_memory_and_te_benchmarks_run_on_card(cuda, monkeypatch):
    """At cut sizes (chip_smoke.py phase 11 runs them at full size)."""
    from repro_torch.benchmarks import memory, run, te_layer, te_linear  # noqa
    from repro_torch.core import bench
    monkeypatch.setattr(memory, "LEVELS", memory.LEVELS[:3] + (
        ("global", "cg", 64 << 20),))
    monkeypatch.setattr(memory, "STREAMS", (("L2", 8 << 20, 4),
                                            ("global", 256 << 20, 1)))
    monkeypatch.setattr(te_linear, "CARD_SIZES", (256, 1024))
    monkeypatch.setattr(te_layer, "CARD_HIDDEN", (1024,))
    memk.reset_launch_counts()
    kfa.reset_launch_counts()
    assert bench.run_all(["memory_latency", "memory_throughput", "te_linear",
                          "te_layer"], fail_fast=True, device=cuda) == 0
    assert all(v > 0 for v in memk.launch_counts().values())
    assert kfa.launch_counts()["flash_attention"] > 0


# ----------------------------------------------------------------------
# the moe and vlm families
# ----------------------------------------------------------------------

FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "dbrx-132b", "internvl2-1b")


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [0, 3], ids=["span", "spec"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_server_graph_replays_equal_eager_units(cuda, arch, spec):
    """A reduced moe / vlm server completes on the card; every unit used
    is captured once and replayed, and a fresh server whose units run
    eagerly serves the same waves to the same streams and pools, bit for
    bit (the moe MLP's combine adds in a fixed order, no atomics)."""
    cfg = reduced_config(arch)
    params = api.init(cfg, 0, device=cuda, dtype=torch.bfloat16)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
              device=cuda, spec_decode=spec)
    graphed = server.ChunkedServer(cfg, params, **kw)
    eager = server.ChunkedServer(cfg, params, **kw)
    for unit in eager._units.values():
        unit.run = unit._eager
    n0 = dict(pk.launch_counts())
    outs = _graph_waves(graphed, cfg, sampled=False)
    assert outs == _graph_waves(eager, cfg, sampled=False)
    assert all(len(o) for wave in outs for o in wave)
    for k in graphed.cache:
        assert torch.equal(graphed.cache[k].view(torch.uint8),
                           eager.cache[k].view(torch.uint8)), k
    want = {"chunk_step": 1, "decode_span": 0 if spec else 1, "cow_copy": 1}
    if spec:
        want["verify_step"] = 1
    assert graphed.compile_counts() == eager.compile_counts() == want
    for name, unit in graphed._units.items():
        if want[name]:
            assert unit.calls >= 3 and unit.captures == 1, name
    ran = {k: v - n0[k] for k, v in pk.launch_counts().items()}
    assert ran["paged_chunk"] > 0
    assert (ran["paged_decode"] > 0) == (spec == 0)


@pytest.mark.gpu
def test_moe_mlp_bitwise_run_to_run_and_replayed(cuda):
    """Full-width moonshot-v1-16b-a3b's moe_mlp (64 experts, top-6, one
    layer's bf16 weights) on 128 rows: two calls and a CUDA-graph replay
    give the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import common, moe
    cfg = get_config("moonshot-v1-16b-a3b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = common.init_params(moe.moe_specs(cfg), gen, cuda, torch.bfloat16)
    x = torch.randn((8, 16, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        y1, a1 = moe.moe_mlp(cfg, p, x)
        y2, a2 = moe.moe_mlp(cfg, p, x)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe.moe_mlp(cfg, p, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y3, a3 = moe.moe_mlp(cfg, p, x)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(y1, y3) and torch.equal(a1, a3)
    assert torch.isfinite(y1.float()).all()


# the families' attention shapes: internvl2-1b (H=14, KH=2: G=7, hd 64)
# and moonshot-v1-16b-a3b (H=KH=16: G=1, hd 128)
FAMILY_PAGED_CASES = [
    # dtype      B  H  KH  hd  NB  bs  MB seed
    ("bfloat16", 4, 14, 2, 64, 40, 16, 8, 21),
    ("float32",  4, 14, 2, 64, 40, 16, 8, 22),
    ("bfloat16", 4, 16, 16, 128, 40, 16, 8, 23),
    ("float32",  4, 16, 16, 128, 40, 16, 8, 24),
]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 5, 16])
@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", FAMILY_PAGED_CASES)
def test_paged_kernels_at_family_shapes_vs_plain(cuda, dtype, B, H, KH, hd,
                                                 NB, bs, MB, seed, C):
    """Decode (C=1) and chunk (C=5, the verify shape at K=4; C=16) calls
    at G=7 / hd 64 and G=1 / hd 128, bf16/float32 and e4m3 pools."""
    q, ck, cv, bt, kv = _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, cuda,
                            C=C)
    kq, vq, sc = _quantized(ck, cv)
    for pools, kw in (((ck, cv), {}), ((kq, vq), sc)):
        suffix = "_fp8" if kw else ""
        if C == 1:
            name, lens = "paged_decode" + suffix, kv
        else:
            name, lens = "paged_chunk" + suffix, torch.clamp(kv - C, min=0)
        fn = getattr(pk, name)
        got = fn(q, *pools, bt, lens, **kw)
        want = getattr(pk, name + "_plain")(q, *pools, bt, lens, **kw)
        err, ok = _paged_err_ok(got, want, dtype)
        assert ok, (name, err)


# ----------------------------------------------------------------------
# the state-space families (models/ssm.py, ssm_lm.py, hybrid.py)
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_mixer_card_vs_cpu(cuda, arch, dtype):
    """One reduced Mamba-1 / Mamba-2 mixer at chunk 8 over L=20 (two
    chunks and a padded one), from a zero and then the carried state,
    card against CPU: float32 within 1e-5 of max |x|, bf16 within four
    bf16 steps of max |x| (exp, the einsums and cuBLAS round apart)."""
    from repro_torch.models import ssm
    cfg = reduced_config(arch)
    params = api.init(cfg, 0, device="cpu")
    if cfg.family == "ssm":
        mixer, p = ssm.mamba1_mixer, {k: v[0] for k, v in
                                      params["layers"]["mixer"].items()}
    else:
        mixer, p = ssm.mamba2_mixer, {k: v[0, 0] for k, v in
                                      params["mamba"]["mixer"].items()}
    x = torch.randn((2, 20, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).to(
        getattr(torch, dtype))
    outs = []
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, st = mixer(cfg, pd, x.to(dev), chunk=8)
        y2, st2 = mixer(cfg, pd, x[:, :5].to(dev), chunk=8, state=st)
        outs.append([t.float().cpu() for t in
                     (y, y2, st["ssm"], st2["ssm"], st["conv"], st2["conv"])])
    rel = 1e-5 if dtype == "float32" else 4 * 2.0 ** -7
    for i, (a, b) in enumerate(zip(*outs)):
        assert (a - b).abs().max() <= rel * a.abs().max(), i


@pytest.mark.gpu
def test_flash_at_zamba2_shared_block_shape(cuda):
    """B9 at zamba2-2.7b's shared attention (B=2, S=512, H = KH = 32,
    hd 80, causal, bf16) runs its mma_sync body, once, within one bf16
    step of max |o| of its plain version and lse within 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(26)
    q, k, v = (torch.randn((2, 512, 32, 80), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    kfa.reset_launch_counts()
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kfa.launch_counts()["flash_attention"] == 1
    assert kfa.body_launches()["mma_sync"] == 1
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (o.float() - po.float()).abs().max() \
        <= 2.0 ** -7 * po.float().abs().max()
    assert ((lse - plse).abs().max()
            / plse.abs().max().clamp(min=1.0)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_decode_step_graph_replays_equal_eager(cuda, arch):
    """The reduced model's api.decode_step as a runtime.graphs.WorkUnit
    (call 1 eager on a side stream, call 2 captured and replayed, then
    replays) gives the eager steps' logits and every cache leaf (states,
    the hybrid's KV) bit for bit, step after step from a prefilled
    state."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.runtime.graphs import WorkUnit
    cfg = reduced_config(arch)
    params = api.init(cfg, 0, device=cuda, dtype=torch.bfloat16)
    B, S, steps = 3, 12, 4
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    graphed = api.init_cache(cfg, B, S + steps, device=cuda)
    api.prefill(cfg, params, {"tokens": toks[:, :S].to(cuda)}, graphed)
    eager = tree_map(lambda t: t.clone(), graphed)
    unit = WorkUnit("decode_step", lambda t, p: (api.decode_step(
        cfg, params, graphed, t, p)[0],), cuda)
    for i in range(steps):
        tok, pos = toks[:, S + i], S + i
        got = unit.run(tok.numpy(), np.array([pos], np.int32))[0].clone()
        want, _ = api.decode_step(cfg, params, eager, tok.to(cuda), pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves(graphed), leaves(eager))), i
    assert unit.captures == 1 and unit.calls == steps


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [1500, 448], ids=["encoder", "cross"])
def test_flash_at_whisper_shapes(cuda, Sq):
    """B9 at whisper-small's bidirectional encoder (1500 x 1500 frames:
    a ragged last 92-key tile) and cross-attention (448 decoder rows x
    1500 frames) shapes, H = KH = 12, hd 64, non-causal, bf16: one
    launch on its wgmma body, o within one bf16 step of max |o| of its
    plain version, lse within 1e-4; gradients with the kernel forward
    within 2**-5 of max |g| of the plain forward's."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((2, Sq, 12, 64), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((2, 1500, 12, 64), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kfa.reset_launch_counts()
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kfa.launch_counts()["flash_attention"] == 1
    assert kfa.body_launches()["wgmma"] == 1
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, causal=False)
    assert (o.float() - po.float()).abs().max() \
        <= 2.0 ** -7 * po.float().abs().max()
    assert ((lse - plse).abs().max()
            / plse.abs().max().clamp(min=1.0)) <= 1e-4
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]

    def grads():
        return torch.autograd.grad(
            attention.flash_attention(*xs, causal=False), xs, do)

    got = grads()
    orig = kfa.flash_attention_fwd
    kfa.flash_attention_fwd = kfa.flash_attention_fwd_plain
    try:
        want = grads()
    finally:
        kfa.flash_attention_fwd = orig
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max() \
            <= 2.0 ** -5 * b.float().abs().max()


def _whisper_cut(layers=2):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("whisper-small"), enc_layers=layers,
                               dec_layers=layers)


@pytest.mark.gpu
def test_encdec_prefill_runs_b9_on_wgmma(cuda):
    """whisper-small at full width cut to 2 + 2 layers: api.prefill on
    1500 bf16 frames launches B9 once an encoder layer, on wgmma, each
    call within the bars of its plain version; the cross K/V hold
    exactly the frames' rows; the step's logits finite."""
    from repro_torch.configs.base import ShapeConfig
    cfg = _whisper_cut()
    params = api.init(cfg, 0, device=cuda, dtype=torch.bfloat16)
    frames = api.make_batch(cfg, ShapeConfig("p", 1500, 2, "prefill"), 0,
                            device=cuda)["frames"]
    orig, worst = kfa.flash_attention_fwd, []

    def checked(q, k, v, **kw):
        o, lse = orig(q, k, v, **kw)
        po, plse = kfa.flash_attention_fwd_plain(q, k, v, **kw)
        worst.append(((o.float() - po.float()).abs().max()
                      / po.float().abs().max()).item())
        return o, lse

    kfa.reset_launch_counts()
    kfa.flash_attention_fwd = checked
    try:
        enc, cache = api.prefill(cfg, params, {"frames": frames},
                                 api.init_cache(cfg, 2, 448, device=cuda))
        torch.cuda.synchronize()
    finally:
        kfa.flash_attention_fwd = orig
    assert kfa.launch_counts()["flash_attention"] == cfg.enc_layers
    assert kfa.body_launches()["wgmma"] == cfg.enc_layers
    assert len(worst) == cfg.enc_layers and max(worst) <= 2.0 ** -7
    assert enc.shape == (2, 1500, cfg.d_model) and cache["xk"].shape[2] == 1500
    lg, _ = api.decode_step(cfg, params, cache,
                            torch.zeros(2, dtype=torch.int32, device=cuda), 0)
    assert lg.shape == (2, cfg.vocab_size) and torch.isfinite(lg.float()).all()


@pytest.mark.gpu
def test_encdec_decode_step_graph_replays_equal_eager(cuda):
    """The reduced whisper-small's api.decode_step as a WorkUnit (call 1
    eager on a side stream, call 2 captured, then replays), after a
    prefill of 24 frames (< max_source_len: the cross K/V are views of
    24 rows of the 32-row buffers): logits and every cache leaf equal
    eager steps' bit for bit."""
    from repro_torch.core.tree import leaves, tree_map
    cfg = reduced_config("whisper-small")
    params = api.init(cfg, 0, device=cuda, dtype=torch.bfloat16)
    B, S, steps = 3, 24, 6
    frames = torch.randn((B, S, cfg.d_model),
                         generator=torch.Generator().manual_seed(5)).to(
        cuda, torch.bfloat16)
    _, graphed = api.prefill(cfg, params, {"frames": frames},
                             api.init_cache(cfg, B, 16, device=cuda))
    assert graphed["xk"].shape[2] == S
    eager = tree_map(lambda t: t.clone(), graphed)
    unit = WorkUnit("decode_step", lambda t, p: (api.decode_step(
        cfg, params, graphed, t, p)[0],), cuda)
    tok = torch.zeros(B, dtype=torch.int32)
    for i in range(steps):
        got = unit.run(tok.numpy(), np.array([i], np.int32))[0].clone()
        want, _ = api.decode_step(cfg, params, eager, tok.to(cuda), i)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves(graphed), leaves(eager))), i
        tok = got.argmax(-1).to(torch.int32).cpu()
    assert unit.captures == 1 and unit.calls == steps


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["int8_ef", "bf16", "none"])
def test_apply_ef_on_card_equals_cpu(cuda, method):
    """optim/compress.apply_ef over three steps of a gradient tree
    (float32 and bf16 leaves, an all-zero leaf) on the card: the
    compressed gradients and the error state equal the CPU's bit for
    bit (divisions tensor by tensor: correctly rounded on both)."""
    from repro_torch.core.tree import items_with_path, tree_map
    from repro_torch.optim import compress
    g = torch.Generator().manual_seed(9)
    ef_d = ef_h = None
    for _ in range(3):
        grads = {"a": torch.randn(4096, generator=g) * 3e-3,
                 "b": {"w": torch.randn((768, 3072), generator=g).to(
                     torch.bfloat16)},
                 "z": torch.zeros(17)}
        dev = tree_map(lambda t: t.to(cuda), grads)
        if ef_d is None:
            ef_d, ef_h = compress.make_ef_state(dev), \
                compress.make_ef_state(grads)
        yd, ef_d = compress.apply_ef(dev, ef_d, method)
        yh, ef_h = compress.apply_ef(grads, ef_h, method)
        for a, b in ((yd, yh), (ef_d, ef_h)):
            for (path, x), (_, y) in zip(items_with_path(a),
                                         items_with_path(b)):
                assert torch.equal(x.cpu(), y), path


@pytest.mark.gpu
def test_analysis_graph_layer_on_card(cuda):
    """Every combo's work units on the card: no finding, one program
    and one capture each, the paged ones launching their kernels."""
    from repro_torch.analysis import contracts, graph_check
    from repro_torch.analysis.report import Report
    rep = Report()
    graph_check.run(rep, device=cuda)
    assert rep.findings == [], [str(f) for f in rep.findings]
    units = rep.extras["graph_units"]
    assert len({u["combo"] for u in units}) == \
        len(contracts.serving_combos())
    for u in units:
        assert (u["programs"], u["captures"]) == (1, 1), u
        assert u["calls"] >= graph_check.MIN_CALLS, u
        for kernel, n in u.get("paged_launches", {}).items():
            assert n > 0, u
    assert sum("paged_launches" in u for u in units) >= 20


@pytest.mark.gpu
def test_analysis_sync_debug_catches_a_host_read(cuda):
    """A toy unit whose body reads a device value on the host fails its
    eager first call under sync debug mode "error" (JX001); the same
    unit without the read captures once and replays clean."""
    from repro_torch.analysis import contracts, graph_check
    from repro_torch.analysis.report import Report
    from repro_torch.models.common import mark

    class Toy:
        def __init__(self, read):
            self.device = cuda
            self.cache = {"k": torch.zeros(4, 8, device=cuda),
                          "v": torch.zeros(4, 8, device=cuda)}
            self.cur_tok = torch.zeros(2, dtype=torch.int32, device=cuda)
            self.out_buf = torch.zeros(2, 8, dtype=torch.int32,
                                       device=cuda)
            self.spec_decode = 0
            self.read = read
            self._units = {"chunk_step": WorkUnit("chunk_step", self.body,
                                                  cuda)}

        def body(self, x):
            if self.read and x.sum().item() < 0:
                x = -x
            self.cache["k"].add_(x[:, None])
            self.cache["v"][:, 0] = x
            mark(x, contracts.SERVING_TAG)
            return (x * 2,)

    for read in (True, False):
        rep = Report()
        toy = Toy(read)
        graph_check.UnitWatch(toy, "toy", rep)
        unit = toy._units["chunk_step"]
        try:
            for i in range(3):
                unit.run(np.full(4, i + 1, np.float32))
        except RuntimeError:
            assert read
        torch.cuda.synchronize()
        if read:
            assert [f.rule for f in rep.findings] == ["JX001"]
        else:
            assert rep.findings == [], [str(f) for f in rep.findings]
            assert (unit.programs, unit.captures, unit.calls) == (1, 1, 3)


@pytest.mark.gpu
def test_analysis_counts_a_recapture(cuda):
    """`captures` counts each capture: a unit whose graph is dropped and
    captured again shows 2, and JX005 names it."""
    from types import SimpleNamespace
    from repro_torch.analysis import graph_check
    from repro_torch.analysis.report import Report
    unit = WorkUnit("chunk_step", lambda x: (x * 2,), cuda)
    for i in range(3):
        unit.run(np.full(4, i + 1, np.float32))
    srv = SimpleNamespace(device=cuda, paged=False, fp8_kv=False,
                          _units={"chunk_step": unit})
    rep = Report()
    graph_check.check_programs(srv, "toy", rep)
    assert unit.captures == 1 and rep.findings == []
    unit.graph = None
    unit.run(np.full(4, 5, np.float32))
    torch.cuda.synchronize()
    rep = Report()
    graph_check.check_programs(srv, "toy", rep)
    assert unit.captures == 2
    assert [f.rule for f in rep.findings] == ["JX005"]


@pytest.mark.gpu
def test_analysis_launch_plans_match_real_launches(cuda):
    """The 13 workloads run on the card: each planned launch matched by
    exactly one real build.launch, no launch unplanned, no finding; a
    plan that is not what runs is refused."""
    from repro_torch.analysis import kernel_lint
    from repro_torch.analysis.report import Report
    rep = Report()
    kernel_lint.run(rep, device=cuda)
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert rep.extras["kernel_launches_matched"] == \
        len(rep.extras["kernel_launches"]) == 13
    first, second = kernel_lint.default_workloads()[:2]
    wrong = kernel_lint.Workload(first.name, second.plan, first.run)
    with pytest.raises(kernel_lint.PlanMismatch):
        kernel_lint.run(Report(), [wrong], device=cuda)


@pytest.mark.gpu
def test_analysis_cli_strict_on_card(cuda, tmp_path):
    import json
    import os
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert main(["--strict", "--max-combos", "2", "--repo-root", root,
                 "--report", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["device"].startswith("cuda") and rep["findings"] == []



TP_SERVERS = {
    "bf16": dict(),
    "fp8_kv": dict(fp8_kv=True),
    "bf16-spec": dict(spec_decode=3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(TP_SERVERS))
def test_tp_graph_replays_equal_eager_units(cuda, mode):
    """Tensor-parallel serving at tp=2 on a mesh spread over the card:
    a server whose units replay their graphs and one whose units run
    eagerly serve the same waves (chunk steps, spans or verify steps,
    copy-on-write copies) to equal streams and equal pools, position by
    position, bit for bit; each unit one program, captured once, and
    its graph launches the paged kernels of both positions."""
    from repro_torch.launch.mesh import make_tp_mesh
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
              **TP_SERVERS[mode])
    graphed = server.ChunkedServer(cfg, params,
                                   mesh=make_tp_mesh(2, spread=cuda), **kw)
    eager = server.ChunkedServer(cfg, params,
                                 mesh=make_tp_mesh(2, spread=cuda), **kw)
    for unit in eager._units.values():
        unit.run = unit._eager
    assert _graph_waves(graphed, cfg, False) == _graph_waves(eager, cfg,
                                                             False)
    a, b = graphed.cache_leaves(), eager.cache_leaves()
    assert set(a) == set(b) and len(a) == 2 * len(graphed.cache[0])
    for k in a:
        assert torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)), k
    assert torch.equal(graphed.out_buf, eager.out_buf)
    want = {"chunk_step": 1, "decode_span": 1, "cow_copy": 1}
    if "spec" in mode:
        want = dict(want, decode_span=0, verify_step=1)
    assert graphed.compile_counts() == want
    L = cfg.num_layers
    kern = "_fp8" if "fp8" in mode else ""
    forward = {"chunk_step": f"paged_chunk{kern}",
               "verify_step": f"paged_chunk{kern}",
               "decode_span": f"paged_decode{kern}"}
    for name, unit in graphed._units.items():
        if want[name]:
            assert unit.calls >= 3 and unit.captures == 1, name
        if name in forward and want[name]:
            steps = 1 if name != "decode_span" else graphed.span
            assert unit.replay_launches[forward[name]][0] == \
                2 * L * steps, name


@pytest.mark.gpu
def test_tp_pools_are_dense_per_position(cuda):
    """Each mesh position holds its own contiguous pools of KH/tp heads
    (k, v and, with e4m3, the scales), on the card, in storage of its
    own; the stats count KV bytes per position."""
    from repro_torch.launch.mesh import make_tp_mesh
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    kw = dict(batch_slots=3, max_len=64, chunk=8, span=4, block_size=8,
              fp8_kv=True)
    one = server.ChunkedServer(cfg, params, device=cuda, **kw)
    for tp in (2, 4):
        srv = server.ChunkedServer(cfg, params,
                                   mesh=make_tp_mesh(tp, spread=cuda), **kw)
        assert len(srv.cache) == tp
        ptrs = set()
        for c in srv.cache:
            for k, t in c.items():
                want = list(one.cache[k].shape)
                want[3] = cfg.num_kv_heads // tp
                assert list(t.shape) == want and t.is_contiguous(), k
                assert t.device.type == "cuda" and t.dtype == \
                    one.cache[k].dtype
                ptrs.add(t.data_ptr())
        assert len(ptrs) == tp * len(srv.cache[0])
        reqs = server.sharegpt_like_requests(3, cfg.vocab_size,
                                             max_input=12, max_output=4,
                                             seed=1)
        assert srv.serve(reqs)["kv_bytes_per_device"] * tp == \
            one.serve(server.clone_requests(reqs))["kv_bytes_per_device"]


@pytest.mark.gpu
def test_sharded_fsdp_tp_step_on_card_equals_cpu(cuda):
    """The reduced yi-6b fsdp_tp step on a (2, 4) mesh spread over the
    card against the same step on a (2, 4) mesh spread over the CPU,
    from the same weights and batch (bf16): the loss within 2e-3 and
    every gathered gradient within 5% of its norm
    (tests/test_torch_train.py's bf16 rules); each position's B9 call
    runs on the card at [B/2, S, H/4, hd] over KH/4 kv heads."""
    from repro_torch.core.tree import items_with_path
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import convert
    from repro_torch.runtime.trainer import value_and_grad
    from repro_torch.sharding.plans import get_plan
    cfg = reduced_config("yi-6b")
    plan = get_plan("fsdp_tp")
    params = api.init(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_host_mesh((2, 4), spread=dev)
        sharded = convert.shard_params(params, cfg, mesh,
                                       rules=plan.param_rules)
        kfa.reset_launch_counts()
        loss, grads = value_and_grad(cfg, sharded, batch, mesh=mesh,
                                     plan=plan)
        out[str(dev)] = (loss.item(), {
            k: g.cpu() for k, g in items_with_path(
                convert.gather_params(grads))})
    assert kfa.shape_launches() == {
        (2, 64, 64, 1, 1, 16, "mma_sync"): 8 * cfg.num_layers}
    (want_loss, want), (loss, got) = out["cpu"], out[str(cuda)]
    assert abs(loss - want_loss) <= 2e-3, (loss, want_loss)
    for k, a in want.items():
        assert torch.linalg.norm(got[k] - a) <= 0.05 * torch.linalg.norm(
            a), k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "whisper-small"])
def test_sharded_family_trainer_on_card_equals_cpu(cuda, arch):
    """Each other family's reduced fsdp_tp Trainer on a (2, 4) mesh spread
    over the card against the same on a (2, 4) mesh spread over the CPU,
    3 steps from the same start and batches (chip_smoke.py phase 17(b)'s
    bars): as it runs (bf16), the first loss within 2e-3 and all within
    1e-2 unless either host's own bf16 run lies further than that from
    its float32 run (a moe's routing ties, the chaotic reduced zamba2:
    the later steps are then rounding); with float32 rows, the first
    loss within 1e-5 relative and all within 5e-4.  B9 runs on the card
    wherever the family attends (8 positions a call site)."""
    import tempfile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.sharding.plans import get_plan
    cfg = reduced_config(arch)
    S, extra = 32, None
    if cfg.family == "encdec":
        S = cfg.max_target_len
        extra = {"frames": ((cfg.max_source_len, cfg.d_model), np.float32)}
    start = api.init(cfg, 0, device="cpu")
    losses, launches = {}, 0
    for rows in ("bf16", "f32"):
        with pytest.MonkeyPatch.context() as mp:
            if rows == "f32":
                keep_f32_rows(mp)
            for dev in ("cpu", cuda):
                with tempfile.TemporaryDirectory() as td:
                    tr = Trainer(cfg, TrainConfig(
                        total_steps=50, warmup_steps=2, ckpt_every=100,
                        ckpt_dir=td, learning_rate=1e-3),
                        data=SyntheticLMData(cfg.vocab_size, 4, S,
                                             extra=extra),
                        mesh=make_host_mesh((2, 4), spread=dev),
                        plan=get_plan("fsdp_tp"))
                    tr.set_params(tree_map(lambda t: t.clone(), start))
                    kfa.reset_launch_counts()
                    losses[rows, str(dev)] = [m.loss for m in tr.run(3)]
                    if dev is cuda and rows == "bf16":
                        launches = kfa.launch_counts()["flash_attention"]

    def apart(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    card, cpu = losses["bf16", str(cuda)], losses["bf16", "cpu"]
    card32, cpu32 = losses["f32", str(cuda)], losses["f32", "cpu"]
    assert abs(card[0] - cpu[0]) <= 2e-3, (card, cpu)
    if max(apart(card, card32), apart(cpu, cpu32)) <= 1e-2:
        assert apart(card, cpu) <= 1e-2, (card, cpu)
    assert abs(card32[0] - cpu32[0]) <= 1e-5 * abs(cpu32[0]), (card32, cpu32)
    assert apart(card32, cpu32) <= 5e-4, (card32, cpu32)
    assert (launches == 0) == (cfg.family == "ssm"), launches
    assert launches % 8 == 0
