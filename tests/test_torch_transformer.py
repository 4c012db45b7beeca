"""Port vs reference: the serving forward, teacher-forced.

Reference weights (`repro.models.api.init`, float32) are bridged with
`convert.from_reference`.  The same tokens, positions and block tables
go through a few `chunk_step`s, then `decode_step`s, of both packages;
each step feeds the reference's argmax to both (teacher forcing).

Tolerance: serving activations are bf16 on both sides, and XLA and
PyTorch round their float32 reductions (rmsnorm, the projections, the
attention sums) in other orders, so a bf16 value on a rounding boundary
rounds one step apart and the next layers carry that on.  Logits and
pools are held to LOGIT_STEPS bf16 steps of the tensor's largest
magnitude (2**-7 * max|x| each); argmax must be equal wherever the
reference's top-2 margin exceeds twice the logits tolerance.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro_torch.configs import reduced_config
from repro_torch.models import api, convert

LOGIT_STEPS = 4


def _tol(ref) -> float:
    return LOGIT_STEPS * 2.0 ** -7 * float(np.abs(ref).max())


def _configs(kv_heads):
    ref_cfg = dataclasses.replace(ref_reduced_config("yi-6b"),
                                  num_kv_heads=kv_heads)
    cfg = dataclasses.replace(reduced_config("yi-6b"),
                              num_kv_heads=kv_heads)
    return ref_cfg, cfg


def _teacher_forced(kv_heads, fp8_kv=False, fp8_linear=False):
    """Two chunk_steps then three decode_steps of the reference and the
    port on the same tokens, positions and tables (-1 tails), each step
    fed the reference's argmax.  Returns [(step, reference logits, port
    logits, reference bf16 logits)] and the two caches; the last item
    is the same steps of the reference without the fp8 options (None
    when there are none)."""
    from repro.te import linear as ref_te_linear
    from repro_torch.te import linear as te_linear
    ref_cfg, cfg = _configs(kv_heads)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    fp8 = fp8_kv or fp8_linear
    jq = ref_te_linear.quantize_serving_params(jp) if fp8_linear else None
    tq = te_linear.quantize_serving_params(tp) if fp8_linear else None
    B, C, bs, MB = 3, 8, 8, 4
    NB = B * MB
    jc, jc0 = (ref_api.init_cache(ref_cfg, B, MB * bs, paged=True,
                                  block_size=bs, num_blocks=NB, fp8_kv=f)
               for f in (fp8_kv, False))
    tc = api.init_cache(cfg, B, MB * bs, block_size=bs, num_blocks=NB,
                        device="cpu", fp8_kv=fp8_kv)
    rng = np.random.default_rng(kv_heads)
    bt = rng.permutation(NB).reshape(B, MB).astype(np.int32)
    bt[1, 3:] = -1                      # -1 tail
    bt[2, 2:] = -1
    chunk = jax.jit(functools.partial(ref_api.chunk_step, ref_cfg))
    decode = jax.jit(functools.partial(ref_api.decode_step, ref_cfg))
    t = torch.from_numpy
    steps = []
    pos = np.zeros(B, np.int32)
    for step, n_tok in enumerate(([8, 5, 3], [8, 2, 0])):
        n_tok = np.asarray(n_tok, np.int32)
        toks = rng.integers(0, ref_cfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = chunk(jp, jc, toks, pos, n_tok, bt, quant=jq)
        jl0 = None
        if fp8:
            jl0, jc0 = chunk(jp, jc0, toks, pos, n_tok, bt)
        tl, _ = api.chunk_step(cfg, tp, tc, t(toks), t(pos), t(n_tok), t(bt),
                               kernel=True, quant=tq)
        steps.append((f"chunk {step}", jl, tl, jl0))
        pos = pos + n_tok
    for step in range(3):
        tok = np.asarray(steps[-1][1], np.float32).argmax(-1).astype(np.int32)
        jl, jc = decode(jp, jc, tok, pos, bt, quant=jq)
        jl0 = None
        if fp8:
            jl0, jc0 = decode(jp, jc0, tok, pos, bt)
        tl, _ = api.decode_step(cfg, tp, tc, t(tok), t(pos), t(bt),
                                kernel=True, quant=tq)
        steps.append((f"decode {step}", jl, tl, jl0))
        pos = pos + 1
    return steps, jc, tc


@pytest.mark.parametrize("kv_heads", [4, 2])         # G = 1, G = 2
def test_teacher_forced_chunk_then_decode(kv_heads):
    steps, jc, tc = _teacher_forced(kv_heads)
    for what, jl, tl, _ in steps:
        a = np.asarray(jl, np.float32)
        b = tl.float().numpy()
        tol = _tol(a)
        assert np.abs(a - b).max() <= tol, (what, np.abs(a - b).max(), tol)
        top = np.sort(a, axis=-1)
        clear = top[:, -1] - top[:, -2] > 2 * tol
        assert (a.argmax(-1) == b.argmax(-1))[clear].all(), what
    for k in ("k", "v"):
        a = np.asarray(jc[k], np.float32)
        b = tc[k].float().numpy()
        assert np.abs(a - b).max() <= _tol(a), k


@pytest.mark.parametrize("kv_heads,fp8_linear", [(4, False), (2, True)])
def test_teacher_forced_fp8(kv_heads, fp8_linear):
    """fp8_kv (+ fp8 linears): the port's logits are nearer the
    reference's than the reference's fp8 logits are to its own bf16
    logits, at every step; at least 85% of the pool codes are equal,
    and layer 0's pools dequantize within one e4m3 step.

    Not held to LOGIT_STEPS: e4m3 has 3 mantissa bits to bf16's 7, so
    a k/v value one bf16 step apart (the cross-framework rounding of
    the bf16 path) lands one e4m3 step (16x larger) apart in about 2%
    of the codes, and a row's or an activation's scale moves with a
    one-step change of its max.  On this chaotic random-weight model
    that gives logit differences up to ~0.45 at |logit| < 4 (ratio to
    the fp8-vs-bf16 error: 0.15-0.6)."""
    steps, jc, tc = _teacher_forced(kv_heads, fp8_kv=True,
                                    fp8_linear=fp8_linear)
    for what, jl, tl, jl0 in steps:
        a = np.asarray(jl, np.float32)
        diff = np.abs(a - tl.float().numpy()).max()
        quant_err = np.abs(a - np.asarray(jl0, np.float32)).max()
        assert diff < quant_err, (what, diff, quant_err)
    for k in ("k", "v"):
        same = (np.asarray(jc[k]).view(np.uint8)
                == tc[k].view(torch.uint8).numpy()).mean()
        assert same >= 0.85, (k, same)          # measured 0.92-0.98
        # layer 0 (same inputs up to the projection): one e4m3 step
        a = np.asarray(jc[k][0], np.float32) * np.asarray(jc[k + "_scale"][0])
        b = (tc[k][0].float() * tc[k + "_scale"][0]).numpy()
        assert np.abs(a - b).max() <= 2.0 ** -3 * np.abs(a).max(), k


def test_kernel_flag_paths_agree_on_cpu():
    """On CPU tensors `kernel=True` runs the kernels' plain versions,
    which are the gather path: both flags give equal logits."""
    _, cfg = _configs(2)
    params = api.init(cfg, 0, device="cpu")
    B, C, bs, MB = 2, 8, 8, 2
    bt = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    toks = torch.randint(0, cfg.vocab_size, (B, C),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    outs = []
    for kernel in (True, False):
        cache = api.init_cache(cfg, B, MB * bs, block_size=bs,
                               device="cpu")
        lg, _ = api.chunk_step(cfg, params, cache, toks,
                               torch.zeros(B, dtype=torch.int32),
                               torch.tensor([8, 4], dtype=torch.int32), bt,
                               kernel=kernel)
        lg2, _ = api.decode_step(cfg, params, cache, lg.argmax(-1).int(),
                                 torch.tensor([8, 4], dtype=torch.int32),
                                 bt, kernel=kernel)
        outs.append((lg, lg2))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_deferred_options_raise():
    _, cfg = _configs(4)
    with pytest.raises(NotImplementedError, match="paged"):
        api.init_cache(cfg, 2, 16, paged=False, device="cpu", fp8_kv=True)
    # moe and vlm are ported; an ssm arch is not
    with pytest.raises(NotImplementedError, match="ssm"):
        api.param_shapes(reduced_config("falcon-mamba-7b"))
