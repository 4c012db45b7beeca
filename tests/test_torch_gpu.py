"""The CUDA kernels of the port on the card (marker `gpu`).

This file imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each test decides inside its `cuda` fixture whether a card is present
and skips without one.  The kernels are held against their plain
versions (kernels/paged_attention.py) on the same inputs: float32 q
within 2e-5, bf16 q within 2e-2 (one bf16 rounding step at |o| < 4),
on bf16/float32 pools and on e4m3 pools with per-row scales.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import api
from repro_torch.runtime import server
from repro_torch.te import fp8

CASES = [       # the CASES of tests/test_paged_kernel.py
    # dtype      B  H  KH  hd  NB  bs  MB seed
    ("float32",  3, 4, 2, 32, 24,  8,  6, 0),
    ("bfloat16", 3, 4, 2, 32, 24,  8,  6, 1),
    ("float32",  2, 6, 6, 16, 17,  4,  8, 3),
    ("bfloat16", 4, 8, 2, 64, 32, 16,  4, 5),
    ("float32",  6, 8, 4, 64, 40, 16,  5, 7),
]
LIMIT = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
        assert (got.float() - want.float()).abs().max().item() \
            <= LIMIT[dtype]


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
        assert (got.float() - want.float()).abs().max().item() \
            <= LIMIT[dtype]


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
    the kernels and the span bookkeeping stay on the device
    (torch.cuda's sync debug mode raises on any sync)."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=cuda)
    srv = server.ChunkedServer(cfg, params, batch_slots=3, max_len=64,
                               chunk=8, span=4, block_size=8, device=cuda,
                               **fp8_opts)
    key = "paged_decode_fp8" if fp8_opts else "paged_decode"
    srv.block_table[:, :2] = np.arange(2 * srv.B).reshape(srv.B, 2)
    ops = [srv._put(x) for x in (np.full(srv.B, 3, np.int32),
                                 np.zeros(srv.B, np.int32),
                                 np.ones(srv.B, bool),
                                 np.full(srv.B, 8, np.int32),
                                 srv.block_table.copy())]
    torch.cuda.synchronize()
    n0 = srv.launch_counts()[key]
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv._span_impl(*ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert srv.launch_counts()[key] == n0 + srv.span * cfg.num_layers


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
