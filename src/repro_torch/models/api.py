"""Model API of the port: parameters, caches and the serving steps.

PyTorch counterpart of ``repro/models/api.py`` for every family: the
transformer families (dense, moe, vlm), ssm (models/ssm_lm.py), hybrid
(models/hybrid.py) and encdec (models/encdec.py):

    param_shapes / init / abstract / pspecs parameters (abstract: meta
                                            tensors; pspecs: their
                                            PartitionSpecs under a
                                            plan's rules)
    loss_fn                                 training objective (one
                                            device, or sharded over a
                                            mesh under a plan)
    init_cache / prefill / decode_step      serving: the transformer
                                            families over a paged pool
                                            (bf16 or fp8 KV) or, with
                                            ``paged=False``, a
                                            contiguous cache; ssm over
                                            its recurrent state; hybrid
                                            over its states and a
                                            contiguous cache; encdec
                                            over its self and cross K/V
    chunk_step                              chunked-prefill serving
    verify_step                             speculative-decode verify
    SamplingParams / sample_tokens          stochastic sample head
    cow_copy_block                          copy-on-write pool block copy
    input_specs / cache_specs / make_batch  shape cells (meta-device
                                            stand-ins; seeded batches)
    active_param_count / model_flops        N (N_active for moe), 6ND

The paged pool, ``chunk_step``, ``verify_step``, ``cow_copy_block``
and the kernel / fp8 serving options are transformer-only, as in the
reference.  The serving steps take ``mesh=`` / ``mesh_axis=`` as the
reference's do: tensor-parallel serving over a 1-axis mesh, with
`params` and `cache` given as one tree a mesh position
(models/convert.shard_params, ``init_cache(..., mesh=)``; see
models/transformer.py).  Entry points run on the CUDA device unless
the caller passes another ``device`` (``"cpu"`` for the tests); with no CUDA
device and no explicit choice they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import common, encdec, hybrid, ssm_lm, transformer
from repro_torch.models.sampling import (GREEDY, SamplingParams,  # noqa: F401
                                         ks_two_sample, sample_tokens)
from repro_torch.sharding.axes import Sharded

Params = Dict[str, Any]

FAMILIES = transformer.FAMILIES + ("ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the family, unless the port has
    `cfg`'s family."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (families "
            f"{FAMILIES})")


def param_shapes(cfg: ModelConfig) -> Params:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.ssm_lm_specs(cfg)
    if cfg.family == "hybrid":
        return hybrid.hybrid_specs(cfg)
    if cfg.family == "encdec":
        return encdec.encdec_specs(cfg)
    return transformer.transformer_specs(cfg)


def abstract(cfg: ModelConfig, dtype: torch.dtype = torch.float32
             ) -> Params:
    """The parameter tree as meta tensors of `param_shapes`' shapes
    (``init``'s dtypes): what the dry run builds its cells from."""
    return common.abstract_params(param_shapes(cfg), dtype)


def pspecs(cfg: ModelConfig, rules: Dict[str, Any],
           mesh_sizes: Optional[Dict[str, int]] = None) -> Params:
    """PartitionSpec of every parameter under `rules` (a plan's
    param_rules), non-dividing dims replicated given `mesh_sizes`."""
    return common.partition_specs(param_shapes(cfg), rules, mesh_sizes)


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on `device`,
    by the reference's per-leaf rules.  Matrices are stored in `dtype`
    and norm scales (every "ones" leaf) in float32; since the forward
    casts every weight to its bf16 activations at use,
    ``dtype=torch.bfloat16`` serves the same numbers in half the
    memory.  The draws differ from JAX's: to compute the reference's
    function, bridge its weights with ``convert.from_reference``."""
    dev = common.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return common.init_params(param_shapes(cfg), gen, dev, dtype)


def _model(cfg: ModelConfig):
    """The module of `cfg`'s family."""
    return {"ssm": ssm_lm, "hybrid": hybrid,
            "encdec": encdec}.get(cfg.family, transformer)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, mesh=None,
            plan=None) -> torch.Tensor:
    """Causal-LM loss: cross-entropy (plus ``aux_loss_weight`` times the
    moe layers' aux loss); a vlm batch may carry ``prefix_embeds``, an
    encdec batch carries ``frames`` (the decoder's tokens against the
    encoded frames).  With ``mesh`` and ``plan`` (a training plan of
    sharding/plans.py) `params` is a tree of ``Sharded`` leaves
    (convert.shard_params(..., rules=plan.param_rules)) and the loss runs
    sharded, every family under every training plan: the family
    module's ``sharded_loss_fn`` (transformer: heads, MLP columns and
    experts over `model`, moe routing global over the batch; ssm_lm /
    hybrid: Mamba-1 channels / Mamba-2 heads over `model`; encdec:
    encoder, decoder and cross-attention heads over `model`)."""
    check_family(cfg)
    if (mesh is None) != (plan is None):
        raise ValueError("pass mesh= and plan= together")
    if mesh is not None:
        return _model(cfg).sharded_loss_fn(cfg, params, batch, mesh, plan)
    return _model(cfg).loss_fn(cfg, params, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, paged: Optional[bool] = None,
               block_size: int = 16, num_blocks: Optional[int] = None,
               device=None, fp8_kv: bool = False, mesh=None,
               plan=None) -> Params:
    """The family's own cache by default: for the transformer families
    a paged block pool or, with ``paged=False``, the contiguous cache
    [L, batch, max_len, KH, hd] (``fp8_kv``, paged only, stores the
    pool as e4m3 codes + per-row float32 scales); for ssm the recurrent
    state (ssm_lm.init_cache); for hybrid the states and the contiguous
    cache of its shared attention (hybrid.init_cache); for encdec the
    decoder's self K/V (at most max_target_len positions) and the cross
    K/V (encdec.init_cache).  A paged or fp8 cache is transformer-only,
    as in the reference.  With a 1-axis ``mesh`` (transformer families)
    one cache a mesh position, on its device, at KH/tp heads.  With a
    training ``plan`` too (sharded prefill / decode): the contiguous
    {"k", "v"} as ``Sharded`` zeros laid by plans.cache_pspecs, each
    block on its owner's device."""
    check_family(cfg)
    if plan is not None:
        if mesh is None:
            raise ValueError("pass mesh= and plan= together")
        transformer.check_sharded_serving(
            cfg, "a paged or fp8 cache" if paged or fp8_kv else None)
        from repro_torch.sharding.plans import cache_pspecs
        shape = ShapeConfig("cache", max_len, batch, "decode")
        specs = cache_pspecs(cfg, shape, plan, mesh)
        return {k: Sharded.zeros(t.shape, dtype, specs[k], mesh)
                for k, t in cache_specs(cfg, shape).items()}
    if mesh is not None:
        transformer.check_family(cfg, "a tensor-parallel cache")
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      paged=True if paged is None else paged,
                                      block_size=block_size,
                                      num_blocks=num_blocks, fp8_kv=fp8_kv,
                                      mesh=mesh)
    dev = common.resolve_device(device)
    if cfg.family in transformer.FAMILIES:
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      paged=True if paged is None else paged,
                                      block_size=block_size,
                                      num_blocks=num_blocks, device=dev,
                                      fp8_kv=fp8_kv)
    if paged or fp8_kv:
        transformer.check_family(cfg, "a paged or fp8 KV cache")
    return _model(cfg).init_cache(cfg, batch, max_len, dtype, device=dev)


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None,
                mesh=None, mesh_axis: Optional[str] = None, plan=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step, the cache updated in place.  With ``mesh`` and
    a training ``plan`` (sharding/plans.py; dense, moe and vlm): the
    step runs sharded over the mesh (transformer.sharded_decode_step:
    `params` as ``Sharded`` leaves by the plan's param rules, `cache` as
    ``init_cache(..., mesh=, plan=)`` lays it, one position `pos` for
    every row), with no other option.  Transformer
    families: ``kernel=True`` reads the paged pool through the CUDA
    block-table kernel (its plain version for CPU tensors);
    ``kernel=False`` is the gather oracle; with no `block_table` the
    cache is contiguous and read by the plain attention; ``quant``
    (te/linear.quantize_serving_params output) serves the linears in
    fp8; ``mesh`` serves tensor-parallel (module docstring).  ssm,
    hybrid and encdec take none of these options."""
    check_family(cfg)
    if plan is not None:
        if mesh is None or mesh_axis is not None:
            raise ValueError("a training plan takes mesh= (no mesh_axis)")
        transformer.check_sharded_serving(
            cfg, "the paged cache, the kernel or fp8 serving" if kernel
            or quant is not None or block_table is not None else None)
        with torch.no_grad():
            return transformer.sharded_decode_step(cfg, params, cache, token,
                                                   pos, mesh, plan)
    if cfg.family not in transformer.FAMILIES:
        if kernel or quant is not None or mesh is not None:
            transformer.check_family(cfg, "kernel/fp8 serving")
        if block_table is not None:
            transformer.check_family(cfg, "a paged KV cache")
    with torch.no_grad():
        if cfg.family in transformer.FAMILIES:
            return transformer.decode_step(cfg, params, cache, token, pos,
                                           block_table, kernel=kernel,
                                           quant=quant, mesh=mesh,
                                           mesh_axis=mesh_axis)
        return _model(cfg).decode_step(cfg, params, cache, token, pos)


def chunk_step(cfg: ModelConfig, params: Params, cache: Params,
               tokens: torch.Tensor, pos, n_tokens: torch.Tensor,
               block_table: Optional[torch.Tensor] = None, *,
               kernel: bool = False,
               quant: Optional[Params] = None, mesh=None,
               mesh_axis: Optional[str] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Chunk-write serving step: per slot, write `n_tokens[b]` of the
    C-wide `tokens[b]` into the cache at `pos[b]` and return logits at
    each slot's last valid row.  Transformer-only: ssm, hybrid and
    encdec serve through prefill / decode_step."""
    check_family(cfg)
    transformer.check_family(cfg, "chunked prefill (use prefill / "
                                  "decode_step)")
    with torch.no_grad():
        return transformer.chunk_step(cfg, params, cache, tokens, pos,
                                      n_tokens, block_table, kernel=kernel,
                                      quant=quant, mesh=mesh,
                                      mesh_axis=mesh_axis)


def verify_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None,
                sample=None, mesh=None, mesh_axis: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Speculative-decode verify: score a [B, C] window of (current
    token + C-1 drafts) per slot and return the next-token id at every
    row (`chunk_step` returns only the last valid row's logits).
    ``sample=(temp, top_k, top_p, seed)`` swaps the argmax chain for the
    sample head (see transformer.verify_step).  Transformer-only."""
    check_family(cfg)
    transformer.check_family(cfg, "speculative decoding (use prefill / "
                                  "decode_step)")
    with torch.no_grad():
        return transformer.verify_step(cfg, params, cache, tokens, pos,
                                       block_table, kernel=kernel,
                                       quant=quant, sample=sample,
                                       mesh=mesh, mesh_axis=mesh_axis)


def cow_copy_block(cfg: ModelConfig, cache: Params, src, dst) -> Params:
    """Copy physical pool block `src` to `dst` in every layer and every
    leaf of the cache (the fp8 layout's scales too), in place: the
    serving runtime's copy-on-write for a shared prefix block.  `src` /
    `dst` are ints or [1] int64 device tensors (the server's graphed
    copy).  Transformer-only (the paged pool).  A tensor-parallel cache
    (a list, one cache a mesh position) copies the block in every
    position's pools."""
    check_family(cfg)
    transformer.check_family(cfg, "a paged KV cache")
    if isinstance(cache, list):
        for c in cache:
            cow_copy_block(cfg, c, src, dst)
        return cache
    from repro_torch.models import attention
    attention.copy_paged_block(cache["k"], cache["v"], src, dst)
    if "k_scale" in cache:
        attention.copy_paged_block(cache["k_scale"], cache["v_scale"], src,
                                   dst)
    return cache


def prefill(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], cache: Params, *, mesh=None,
            plan=None) -> Tuple[torch.Tensor, Params]:
    """Run a prompt batch ({"tokens": [B, S]}, a vlm's ``prefix_embeds``
    too; encdec: {"frames": [B, S_enc, d]}).  Returns (last-position
    logits [B, vocab], cache), for encdec (encoder output, cache).

    * transformer families: transformer.prefill fills the contiguous
      cache (``init_cache(..., paged=False)``) and returns {"k", "v"};
    * ssm: the recurrence from the cache's state, the final state left
      in the cache;
    * hybrid: the training forward, read at the last position; the
      cache comes back as it came, its states and KV untouched, as in
      the reference (its serving rebuilds the state through
      decode_step);
    * encdec: encodes the frames and writes each decoder layer's cross
      K/V into the cache (encdec.prefill; the returned cache's cross
      K/V are views of the S_enc rows written).

    With ``mesh`` and ``plan`` (a training plan; dense, moe and vlm) the
    prefill runs sharded (transformer.sharded_prefill): `params` as
    ``Sharded`` leaves by the plan's param rules, `cache` as
    ``init_cache(..., mesh=, plan=)`` lays it; ssm, hybrid and encdec
    raise NotImplementedError naming ROADMAP.md's next item."""
    check_family(cfg)
    if (mesh is None) != (plan is None):
        raise ValueError("pass mesh= and plan= together")
    if mesh is not None:
        with torch.no_grad():
            return transformer.sharded_prefill(cfg, params, batch, cache,
                                               mesh, plan)
    with torch.no_grad():
        if cfg.family in transformer.FAMILIES:
            return transformer.prefill(
                cfg, params, batch["tokens"], cache,
                prefix_embeds=batch.get("prefix_embeds"))
        if cfg.family == "ssm":
            return ssm_lm.prefill(cfg, params, batch["tokens"], cache)
        if cfg.family == "encdec":
            return encdec.prefill(cfg, params, batch["frames"], cache)
        h, _ = hybrid.forward(cfg, params, batch["tokens"])
        return transformer.logits_fn(cfg, params, h[:, -1:])[:, 0], cache


# ----------------------------------------------------------------------
# shape cells: meta-device input specs and concrete seeded batches
# ----------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins on the meta device (shape and dtype, no storage) for
    every model input of this cell.  encdec: the cell's seq_len is the
    source frame count (clamped to max_source_len); its decoder runs at
    max_target_len."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    frames = (B, min(S, cfg.max_source_len), cfg.d_model)
    prefix = (cfg.family == "vlm" and cfg.num_prefix_tokens)
    if shape.kind == "train":
        if cfg.family == "encdec":
            T = cfg.max_target_len
            return {"frames": spec(frames, bf16),
                    "tokens": spec((B, T), i32),
                    "labels": spec((B, T), i32)}
        out = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
        if prefix:
            out["prefix_embeds"] = spec(
                (B, cfg.num_prefix_tokens, cfg.d_model), bf16)
        return out
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": spec(frames, bf16)}
        out = {"tokens": spec((B, S), i32)}
        if prefix:
            out["prefix_embeds"] = spec(
                (B, cfg.num_prefix_tokens, cfg.d_model), bf16)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"token": spec((B,), i32), "pos": spec((), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Params:
    """The serving cache of this cell on the meta device: the
    reference's (``init_cache`` at its defaults: the contiguous layout
    for the transformer families)."""
    paged = False if cfg.family in transformer.FAMILIES else None
    return init_cache(cfg, shape.global_batch, shape.seq_len, paged=paged,
                      device="meta")


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
               device=None) -> Dict[str, torch.Tensor]:
    """A random batch of `input_specs` on `device`, drawn in the specs'
    order from one seeded ``torch.Generator``: token ids uniform in
    [0, vocab_size), floats standard normal cast to the spec's dtype,
    the scalar pos min(seq_len - 1, 1).  The draws differ from JAX's;
    the shapes, dtypes and ranges are the reference's."""
    dev = common.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            if not s.shape:
                out[k] = torch.tensor(min(shape.seq_len - 1, 1),
                                      dtype=torch.int32, device=dev)
                continue
            hi = (cfg.vocab_size if k in ("tokens", "labels", "token")
                  else max(shape.seq_len - 1, 1))
            out[k] = torch.randint(0, hi, s.shape, generator=gen,
                                   dtype=torch.int32, device=dev)
        else:
            out[k] = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                                 device=dev).to(s.dtype)
    return out


def active_param_count(cfg: ModelConfig) -> float:
    """N (dense, vlm, ssm, hybrid, encdec) or N_active (moe: experts
    counted at top_k/E)."""
    total = float(common.count_params(param_shapes(cfg)))
    if cfg.family != "moe":
        return total
    expert = common.count_params(
        {k: v for k, v in transformer.layer_specs(cfg)["moe"].items()
         if k != "router"})
    expert_total = float(expert * cfg.num_layers)
    frac = cfg.top_k / cfg.num_experts
    return total - expert_total * (1.0 - frac)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D for a train cell, 2*N*D for prefill and decode (one token a
    sequence).  encdec counts the source frames (clamped to
    max_source_len) plus, in training, the max_target_len decoder
    tokens."""
    n_active = active_param_count(cfg)
    src = min(shape.seq_len, cfg.max_source_len)
    if shape.kind == "train":
        if cfg.family == "encdec":
            tokens = shape.global_batch * (src + cfg.max_target_len)
        else:
            tokens = shape.tokens
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (
            src if cfg.family == "encdec" else shape.seq_len)
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch
