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


@pytest.mark.parametrize("kv_heads", [4, 2])         # G = 1, G = 2
def test_teacher_forced_chunk_then_decode(kv_heads):
    ref_cfg, cfg = _configs(kv_heads)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    B, C, bs, MB = 3, 8, 8, 4
    NB = B * MB
    jc = ref_api.init_cache(ref_cfg, B, MB * bs, paged=True, block_size=bs,
                            num_blocks=NB)
    tc = api.init_cache(cfg, B, MB * bs, block_size=bs, num_blocks=NB,
                        device="cpu")
    rng = np.random.default_rng(kv_heads)
    bt = rng.permutation(NB).reshape(B, MB).astype(np.int32)
    bt[1, 3:] = -1                      # -1 tail
    bt[2, 2:] = -1
    chunk = jax.jit(functools.partial(ref_api.chunk_step, ref_cfg))
    decode = jax.jit(functools.partial(ref_api.decode_step, ref_cfg))

    def compare(jl, tl, what):
        a = np.asarray(jl, np.float32)
        b = tl.float().numpy()
        tol = _tol(a)
        assert np.abs(a - b).max() <= tol, (what, np.abs(a - b).max(), tol)
        top = np.sort(a, axis=-1)
        clear = top[:, -1] - top[:, -2] > 2 * tol
        assert (a.argmax(-1) == b.argmax(-1))[clear].all(), what
        return a.argmax(-1).astype(np.int32)

    pos = np.zeros(B, np.int32)
    for step, n_tok in enumerate(([8, 5, 3], [8, 2, 0])):
        n_tok = np.asarray(n_tok, np.int32)
        toks = rng.integers(0, ref_cfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = chunk(jp, jc, toks, pos, n_tok, bt)
        tl, _ = api.chunk_step(cfg, tp, tc, torch.from_numpy(toks),
                               torch.from_numpy(pos),
                               torch.from_numpy(n_tok),
                               torch.from_numpy(bt), kernel=True)
        tok = compare(jl, tl, f"chunk {step}")
        pos = pos + n_tok
    for step in range(3):
        jl, jc = decode(jp, jc, tok, pos, bt)
        tl, _ = api.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos), torch.from_numpy(bt),
                                kernel=True)
        tok = compare(jl, tl, f"decode {step}")
        pos = pos + 1
    for k in ("k", "v"):
        a = np.asarray(jc[k], np.float32)
        b = tc[k].float().numpy()
        assert np.abs(a - b).max() <= _tol(a), k


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
    with pytest.raises(NotImplementedError):
        api.init_cache(cfg, 2, 16, paged=False, device="cpu")
    with pytest.raises(NotImplementedError):
        api.init_cache(cfg, 2, 16, fp8_kv=True, device="cpu")
    with pytest.raises(NotImplementedError):
        api.param_shapes(reduced_config("dbrx-132b"))
