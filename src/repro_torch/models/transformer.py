"""Decoder-only transformer LM (dense, moe, vlm): training and serving.

PyTorch counterpart of ``repro/models/transformer.py``: the dense
family, the moe family (its MLP is ``models/moe.moe_mlp``) and the vlm
backbone (the dense body, with ``prefix_embeds`` in place of the first
token rows).  Layer parameters keep the reference's stacked layout (every
leaf under "layers" has a leading [L] axis, so weights bridge across
unchanged); the reference's scan over layers becomes a Python loop over
layer slices.  The training forward runs each layer under the config's
remat policy (none | dots | full | full_save_attn) through
``torch.utils.checkpoint``; remat changes what is kept for the backward,
never the numbers.  The serving steps' KV cache (the paged pool, or
the contiguous layout with no block table) is updated in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sampling
from repro_torch.models.common import (ParamSpec, apply_norm, apply_rope,
                                       chunked_softmax_xent, cross_entropy,
                                       norm_spec)

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

# the families this module serves and trains (the reference's
# api._TRANSFORMER_FAMILIES)
FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg) -> None:
    """Raise NotImplementedError, naming the family, unless `cfg` is of
    a transformer family (dense, moe, vlm): the ssm, hybrid and encdec
    families are not ported."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (transformer "
            f"families {FAMILIES} only)")


def layer_specs(cfg) -> Params:
    specs: Params = {
        "ln1": norm_spec(cfg, cfg.d_model),
        "ln2": norm_spec(cfg, cfg.d_model),
        "attn": attn.attn_specs(cfg),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_mod.mlp_specs(cfg)
    return specs


def stack_specs(specs: Params, n: int) -> Params:
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, init=specs.init,
                         scale=specs.scale)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def transformer_specs(cfg) -> Params:
    specs: Params = {
        "embed": ParamSpec((cfg.padded_vocab_size, cfg.d_model), scale=0.02),
        "layers": stack_specs(layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab_size))
    return specs


def layer_slice(tree: Params, i: int) -> Params:
    """Layer i's parameters: a view of every stacked leaf at index i."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def layer_list(tree: Params, n: int) -> List[Params]:
    """The n layers' parameters, each leaf of the stack unbound once
    (so the backward stacks the n layer gradients in one op)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: layer_list(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


# ----------------------------------------------------------------------
# training: blocks, remat, forward, loss
# ----------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity (a copy) tagged with `name`, as the reference's
    ``jax.ad_checkpoint.checkpoint_name``: a selective-checkpoint
    policy can keep its output for the backward by this op."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def attn_block(cfg, p, x: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    q, k, v = attn.qkv_project(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True,
                             window=cfg.sliding_window)
    # tagged so remat="full_save_attn" keeps it instead of recomputing
    o = checkpoint_name(o, "attn_out")
    return attn.out_project(p, o)


def layer_fwd(cfg, p, x: torch.Tensor, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block. Returns (x, aux_loss)."""
    h = apply_norm(cfg, x, p["ln1"])
    x = x + attn_block(cfg, p["attn"], h, positions)
    h = apply_norm(cfg, x, p["ln2"])
    if cfg.family == "moe":
        y, aux = moe_mod.moe_mlp(cfg, p["moe"], h)
    else:
        y = mlp_mod.mlp(cfg, p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


# the 2-D products a layer runs (projections, MLP): what "dots" keeps,
# as the reference's dots_with_no_batch_dims_saveable (the attention
# einsums have batch dims and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attn_out(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.checkpoint_name.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """none: keep everything; full: keep only the inputs; dots: keep the
    outputs of the layer's matrix products; full_save_attn: keep the
    attention output.  The rest is recomputed in the backward."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    policy = _save_attn_out if cfg.remat == "full_save_attn" else _save_dots
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


def embed_tokens(cfg, params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """bf16 rows of the embedding (looked up, then cast: the values of
    casting first; the backward adds repeated tokens' gradients in
    float32, deterministically)."""
    x = F.embedding(tokens.long(), params["embed"]).to(torch.bfloat16)
    if prefix_embeds is not None:
        npfx = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, npfx:]], dim=1)
    return x


def forward(cfg, params, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (final hidden [B,S,d] (pre-unembed), aux)."""
    check_family(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    layer = _remat(cfg, functools.partial(layer_fwd, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(params["layers"], cfg.num_layers):
        x, a = layer(lp, x, positions)
        aux = aux + a
    return apply_norm(cfg, x, params["final_norm"]), aux


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal-LM loss; big vocabs go through the chunked-CE loop."""
    h, aux = forward(cfg, params, batch["tokens"],
                     prefix_embeds=batch.get("prefix_embeds"))
    B, S, d = h.shape
    labels = batch["labels"]
    w = unembed_matrix(cfg, params).to(h.dtype)
    if cfg.vocab_size * S * B > 2 ** 28:       # big-vocab: chunk token dim
        ce = chunked_softmax_xent(h.reshape(B * S, d), w,
                                  labels.reshape(B * S))
    else:
        ce = cross_entropy(h @ w, labels)
    return ce + cfg.aux_loss_weight * aux


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def unembed_matrix(cfg, params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def logits_fn(cfg, params, h: torch.Tensor) -> torch.Tensor:
    out = h @ unembed_matrix(cfg, params).to(h.dtype)
    # drop the TP-padding columns (never valid tokens)
    if cfg.padded_vocab_size != cfg.vocab_size:
        out = out[..., : cfg.vocab_size]
    return out


def serving_det_groups(cfg) -> Tuple[int, int]:
    """(attention, mlp) group counts of the grouped float32 reductions
    of the serving forward: the largest power of two <= 16 dividing the
    head count / hidden width, as in the reference."""
    def pow2_div(n: int, cap: int = 16) -> int:
        g = 1
        while g < cap and n % (g * 2) == 0:
            g *= 2
        return g
    return pow2_div(cfg.num_heads), pow2_div(cfg.d_ff)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               paged: bool = True, block_size: int = 16,
               num_blocks: Optional[int] = None, device=None,
               fp8_kv: bool = False) -> Params:
    """Paged block pool [L, num_blocks, block_size, KH, hd] addressed
    through a per-slot block table or, with ``paged=False``, the
    contiguous cache {"k", "v"} [L, batch, max_len, KH, hd].  The
    default pool matches the contiguous capacity (batch *
    ceil(max_len / block_size) blocks).  ``fp8_kv`` (paged only) stores
    e4m3 codes + per-row float32 scales (attention.init_paged_kv_cache)."""
    if not paged:
        if fp8_kv:
            raise NotImplementedError(
                "fp8_kv requires the paged cache layout")
        # the reference's serving cache carries no "length" leaf
        cache = attn.init_kv_cache(cfg, batch, max_len,
                                   layers=cfg.num_layers, dtype=dtype,
                                   device=device)
        del cache["length"]
        return cache
    if num_blocks is None:
        num_blocks = batch * -(-max_len // block_size)
    return attn.init_paged_kv_cache(num_blocks, block_size,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    layers=cfg.num_layers, dtype=dtype,
                                    device=device, fp8=fp8_kv)


def _cache_attend(q, k1, v1, cl, pos, positions, block_table, *,
                  decode: bool, kernel: bool) -> torch.Tensor:
    """Write a window's k/v into one layer's cache slice `cl` (in place:
    contiguous {"k","v"} when `block_table` is None, else paged bf16
    {"k","v"} or fp8 {"k","v","k_scale","v_scale"}, detected by key)
    and attend over the result.  The contiguous layout reads through
    the plain attention, as in the reference; the kernels take a block
    table, so ``kernel=True`` without one raises.  ``kernel=True`` reads
    the pool through the CUDA block-table kernels; ``kernel=False``
    gathers the virtual view and runs the plain attention (the A/B
    oracle)."""
    if block_table is None:
        if kernel:
            raise ValueError("kernel=True reads the paged pool through "
                             "its block table: pass block_table")
        ck, cv = attn.update_cache(cl["k"], cl["v"], k1, v1, pos)
        if decode:
            return attn.decode_attention(q, ck, cv, pos + 1)
        return attn.chunk_attention(q, ck, cv, positions)
    if "k_scale" in cl:
        attn.update_paged_cache_fp8(cl, k1, v1, pos, block_table)
        scales = {"k_scale": cl["k_scale"], "v_scale": cl["v_scale"]}
    else:
        attn.update_paged_cache(cl["k"], cl["v"], k1, v1, pos, block_table)
        scales = {}
    if kernel:
        if decode:
            return attn.paged_decode_attention(q, cl["k"], cl["v"],
                                               block_table, pos + 1,
                                               **scales)
        return attn.paged_chunk_attention(q, cl["k"], cl["v"],
                                          block_table, pos, **scales)
    if scales:
        kg, vg = attn.gather_paged_cache_fp8(cl, block_table,
                                             out_dtype=q.dtype)
    else:
        kg, vg = attn.gather_paged_cache(cl["k"], cl["v"], block_table)
    if decode:
        return attn.decode_attention(q, kg, vg, pos + 1)
    return attn.chunk_attention(q, kg, vg, positions)


def _serving_scan(cfg, params, cache, x, pos, positions, block_table, *,
                  decode: bool, kernel: bool,
                  quant: Optional[Params] = None) -> torch.Tensor:
    """All layers over x [B, S, d] (each layer's pools updated in
    place), then the final norm.  ``quant`` (te/linear.
    quantize_serving_params output) routes the projections and the MLP
    through the pre-quantized fp8 weights (dense and vlm only).  The
    moe family's MLP is `moe_mlp` over the whole [B, S] window, padding
    rows included (they count in its capacity, as in the reference);
    its aux loss is dropped."""
    ga, gm = serving_det_groups(cfg)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        qlp = None if quant is None else layer_slice(quant["layers"], i)
        cl = {k: leaf[i] for k, leaf in cache.items()}
        h = apply_norm(cfg, x, lp["ln1"])
        if qlp is None:
            q, k1, v1 = attn.qkv_project(cfg, lp["attn"], h)
        else:
            q, k1, v1 = attn.qkv_project_fp8(cfg, lp["attn"], qlp["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k1 = apply_rope(k1, positions, cfg.rope_theta)
        o = _cache_attend(q, k1, v1, cl, pos, positions, block_table,
                          decode=decode, kernel=kernel)
        if qlp is None:
            x = x + attn.out_project(lp["attn"], o, groups=ga)
        else:
            x = x + attn.out_project_fp8(lp["attn"], qlp["attn"], o)
        h = apply_norm(cfg, x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_mod.moe_mlp(cfg, lp["moe"], h)[0]
        elif qlp is None:
            x = x + mlp_mod.mlp(cfg, lp["mlp"], h, groups=gm)
        else:
            x = x + mlp_mod.mlp_fp8(cfg, lp["mlp"], qlp["mlp"], h)
    return apply_norm(cfg, x, params["final_norm"])


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Serving activations are bf16 whatever the parameter dtype (the
    rows are cast after the lookup, the same values as casting first)."""
    return params["embed"][tokens.long()].to(torch.bfloat16)


def _per_slot_pos(pos, B: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device)
    return pos.to(torch.int32).expand(B)


def decode_step(cfg, params, cache: Params, token: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token [B]; pos scalar or [B] int32 (current
    length): each layer writes its k/v at `pos` (through the table, or
    into the contiguous cache when `block_table` is None) and attends
    to positions <= pos.  ``quant`` routes the linears through
    pre-quantized fp8 weights.  Returns (logits [B, vocab], cache); the
    cache is the same pool, updated in place."""
    B = token.shape[0]
    pos = _per_slot_pos(pos, B, token.device)
    x = _embed(params, token)[:, None, :]                 # [B,1,d]
    x = _serving_scan(cfg, params, cache, x, pos, pos[:, None],
                      block_table, decode=True, kernel=kernel, quant=quant)
    return logits_fn(cfg, params, x)[:, 0], cache


def _chunk_fwd(cfg, params, cache: Params, tokens: torch.Tensor,
               pos: torch.Tensor, block_table: Optional[torch.Tensor], *,
               kernel: bool, quant: Optional[Params]) -> torch.Tensor:
    """Shared serving forward over a [B, C] token window written into
    the pool at [pos, pos+C): the body of both `chunk_step` (which reads
    out the last valid row) and `verify_step` (which reads out every
    row).  Returns the final hidden [B, C, d]."""
    C = tokens.shape[1]
    x = _embed(params, tokens)                            # [B,C,d]
    positions = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=tokens.device)[None, :]
    return _serving_scan(cfg, params, cache, x, pos, positions,
                         block_table, decode=False, kernel=kernel,
                         quant=quant)


def chunk_step(cfg, params, cache: Params, tokens: torch.Tensor, pos,
               n_tokens: torch.Tensor,
               block_table: Optional[torch.Tensor] = None, *,
               kernel: bool = False, quant: Optional[Params] = None
               ) -> Tuple[torch.Tensor, Params]:
    """One chunked-prefill/decode step for a batch of server slots.

    tokens [B,C] int32 — per slot, the next `n_tokens[b]` tokens of its
    request (rows past n_tokens[b] are padding); pos [B] int32 — each
    slot's cache length; the chunk's k/v is written at [pos, pos+C)
    through the table (padding rows whose virtual block is unallocated
    are dropped) or, with no table, into the contiguous cache (padding
    rows land past the frontier, where the next write lands first).  Returns (logits [B, vocab] at each slot's last valid
    row, cache)."""
    B, C = tokens.shape
    pos = _per_slot_pos(pos, B, tokens.device)
    x = _chunk_fwd(cfg, params, cache, tokens, pos, block_table,
                   kernel=kernel, quant=quant)
    last = (n_tokens.long() - 1).clamp(0, C - 1)          # [B]
    h_last = torch.gather(x, 1, last[:, None, None].expand(B, 1,
                                                            x.shape[-1]))
    return logits_fn(cfg, params, h_last)[:, 0], cache


def verify_step(cfg, params, cache: Params, tokens: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False,
                quant: Optional[Params] = None, sample=None
                ) -> Tuple[torch.Tensor, Params]:
    """Speculative-decode verify: score a [B, C] window (row 0 = each
    slot's current token, rows 1..C-1 = draft tokens) in one call and
    return the next-token id at EVERY row.

    The `chunk_step` forward (the same k/v writes at [pos, pos+C), the
    same causal read, through the paged chunk kernel with
    ``kernel=True``), read out at every row.  Rows past the accepted
    frontier leave k/v beyond it, which no later read sees before the
    next window overwrites it; rows past the slot's allocated blocks
    are dropped at the write.

    ``sample=(temp, top_k, top_p, seed)`` (each ``[B]``) draws row j's
    token with the sample head (models/sampling.sample_tokens) keyed by
    ``(seed[b], pos[b] + 1 + j)``: the key the span loop uses for the
    same emitted position.  Greedy rows stay the argmax.
    ``sample=None`` is the argmax head.

    Returns (preds [B, C] int32, cache)."""
    B, C = tokens.shape
    pos = _per_slot_pos(pos, B, tokens.device)
    x = _chunk_fwd(cfg, params, cache, tokens, pos, block_table,
                   kernel=kernel, quant=quant)
    logits = logits_fn(cfg, params, x)                    # [B,C,V]
    if sample is None:
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    temp, top_k, top_p, seed = sample
    index = pos[:, None] + 1 + torch.arange(C, dtype=torch.int32,
                                            device=tokens.device)[None, :]
    return sampling.sample_tokens(logits, temp, top_k, top_p, seed,
                                  index), cache
