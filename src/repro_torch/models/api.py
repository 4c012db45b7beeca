"""Model API of the port: parameters, KV cache and the serving steps.

PyTorch counterpart of ``repro/models/api.py`` for the dense family:

    param_shapes / init                     parameters
    loss_fn                                 training objective
    init_cache / decode_step / chunk_step   serving over a paged pool
                                            (bf16 or fp8 KV) or, with
                                            ``paged=False`` and no block
                                            table, a contiguous cache;
                                            ``quant=`` fp8 linears
    verify_step                             speculative-decode verify
    SamplingParams / sample_tokens          stochastic sample head
    cow_copy_block                          copy-on-write pool block copy

Entry points run on the CUDA device unless the caller passes another
``device`` (``"cpu"`` for the tests); with no CUDA device and no
explicit choice they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer
from repro_torch.models.sampling import (GREEDY, SamplingParams,  # noqa: F401
                                         ks_two_sample, sample_tokens)

Params = Dict[str, Any]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def param_shapes(cfg: ModelConfig) -> Params:
    _dense_only(cfg)
    return transformer.transformer_specs(cfg)


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on `device`,
    by the reference's per-leaf rules.  Matrices are stored in `dtype`
    and norm scales in float32; since the serving forward casts every
    weight to its bf16 activations at use, ``dtype=torch.bfloat16``
    serves the same numbers in half the memory.  The draws differ from
    JAX's: to compute the reference's function, bridge its weights with
    ``convert.from_reference``."""
    dev = common.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return common.init_params(param_shapes(cfg), gen, dev, dtype)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal-LM loss of the dense family (transformer.loss_fn); the
    other families are not ported yet."""
    _dense_only(cfg)
    return transformer.loss_fn(cfg, params, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, paged: bool = True,
               block_size: int = 16, num_blocks: Optional[int] = None,
               device=None, fp8_kv: bool = False) -> Params:
    """A paged block pool or, with ``paged=False``, the contiguous cache
    [L, batch, max_len, KH, hd].  ``fp8_kv`` (paged only) stores the
    pool as e4m3 codes + per-row float32 scales, read by the fp8
    kernels."""
    _dense_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, paged=paged,
                                  block_size=block_size,
                                  num_blocks=num_blocks,
                                  device=common.resolve_device(device),
                                  fp8_kv=fp8_kv)


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """``kernel=True`` reads the paged pool through the CUDA
    block-table kernel (its plain version for CPU tensors);
    ``kernel=False`` is the gather oracle.  With no `block_table` the
    cache is contiguous and read by the plain attention.  ``quant`` (te/linear.
    quantize_serving_params output) serves the linears in fp8."""
    _dense_only(cfg)
    with torch.no_grad():
        return transformer.decode_step(cfg, params, cache, token, pos,
                                       block_table, kernel=kernel,
                                       quant=quant)


def chunk_step(cfg: ModelConfig, params: Params, cache: Params,
               tokens: torch.Tensor, pos, n_tokens: torch.Tensor,
               block_table: Optional[torch.Tensor] = None, *,
               kernel: bool = False,
               quant: Optional[Params] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Chunk-write serving step: per slot, write `n_tokens[b]` of the
    C-wide `tokens[b]` into the cache at `pos[b]` and return logits at
    each slot's last valid row."""
    _dense_only(cfg)
    with torch.no_grad():
        return transformer.chunk_step(cfg, params, cache, tokens, pos,
                                      n_tokens, block_table, kernel=kernel,
                                      quant=quant)


def verify_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None,
                sample=None) -> Tuple[torch.Tensor, Params]:
    """Speculative-decode verify: score a [B, C] window of (current
    token + C-1 drafts) per slot and return the next-token id at every
    row (`chunk_step` returns only the last valid row's logits).
    ``sample=(temp, top_k, top_p, seed)`` swaps the argmax chain for the
    sample head (see transformer.verify_step)."""
    _dense_only(cfg)
    with torch.no_grad():
        return transformer.verify_step(cfg, params, cache, tokens, pos,
                                       block_table, kernel=kernel,
                                       quant=quant, sample=sample)


def cow_copy_block(cfg: ModelConfig, cache: Params, src, dst) -> Params:
    """Copy physical pool block `src` to `dst` in every layer and every
    leaf of the cache (the fp8 layout's scales too), in place: the
    serving runtime's copy-on-write for a shared prefix block.  `src` /
    `dst` are ints or [1] int64 device tensors (the server's graphed
    copy)."""
    _dense_only(cfg)
    from repro_torch.models import attention
    attention.copy_paged_block(cache["k"], cache["v"], src, dst)
    if "k_scale" in cache:
        attention.copy_paged_block(cache["k_scale"], cache["v_scale"], src,
                                   dst)
    return cache
