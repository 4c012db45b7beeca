"""Hybrid SSM+attention LM (zamba2-2.7b: a Mamba-2 stack with a *shared*
attention block applied every `attn_every` layers).

PyTorch counterpart of ``repro/models/hybrid.py``.  The layer stack is
`num_layers / attn_every` super-blocks: each runs `attn_every` Mamba-2
layers (parameters stacked [NS, attn_every, ...]) and then the single
shared attention+MLP block (parameters unstacked), so the KV cache
holds `num_superblocks` entries instead of `num_layers`.  The shared
block's attention over a whole sequence is ``flash_attention``: the
hand-written B9 kernel on the card (its mma_sync body at zamba2's
head_dim 80).  Decode keeps the Mamba-2 states and a contiguous KV
cache, updated in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.common import (ParamSpec, apply_norm, apply_rope,
                                       norm_spec)
from repro_torch.models.transformer import (_embed, _remat, embed_tokens,
                                            layer_list, layer_slice,
                                            lm_xent, logits_fn, stack_specs)

Params = Dict[str, Any]


def n_superblocks(cfg) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of attn_every {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def hybrid_specs(cfg) -> Params:
    mamba_layer = {"ln": norm_spec(cfg, cfg.d_model),
                   "mixer": ssm.mamba2_specs(cfg)}
    inner = stack_specs(mamba_layer, cfg.attn_every, "inner_layers")
    shared = {
        "ln1": norm_spec(cfg, cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "ln2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp_mod.mlp_specs(cfg),
    }
    specs: Params = {
        "embed": ParamSpec((cfg.padded_vocab_size, cfg.d_model),
                           ("vocab", "embed"), scale=0.02),
        "mamba": stack_specs(inner, n_superblocks(cfg)),
        "shared": shared,
        "final_norm": norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab_size),
                                     ("embed", "vocab"))
    return specs


def shared_block(cfg, sp, x: torch.Tensor, positions: torch.Tensor
                 ) -> torch.Tensor:
    """The shared attention+MLP block over a whole sequence (causal)."""
    h = apply_norm(cfg, x, sp["ln1"])
    q, k, v = attn.qkv_project(cfg, sp["attn"], h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True)
    x = x + attn.out_project(sp["attn"], o)
    h = apply_norm(cfg, x, sp["ln2"])
    return x + mlp_mod.mlp(cfg, sp["mlp"], h)


def _mamba_block(cfg, lp, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, lp["ln"])
    y, _ = ssm.mamba2_mixer(cfg, lp["mixer"], h)
    return x + y


def forward(cfg, params, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (final hidden [B,S,d], zero aux loss); each
    Mamba-2 layer and each application of the shared block under the
    config's remat policy."""
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    blk = _remat(cfg, functools.partial(_mamba_block, cfg))
    shared = _remat(cfg, functools.partial(shared_block, cfg))
    for sb in layer_list(params["mamba"], n_superblocks(cfg)):
        for lp in layer_list(sb, cfg.attn_every):
            x = blk(lp, x)
        x = shared(params["shared"], x, positions)
    x = apply_norm(cfg, x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    h, _ = forward(cfg, params, batch["tokens"])
    return lm_xent(cfg, params, h, batch["labels"])


def _sharded_mamba_block(cfg, g, lp, xd, read):
    h = T.norm(cfg, g, lp["ln"], xd, read)
    y = ssm.sharded_mamba2(cfg, lp["mixer"], g, h, read)
    return {d: xd[d] + y[d] for d in g.devices}


def sharded_loss_fn(cfg, params, batch: Dict[str, torch.Tensor], mesh,
                    plan) -> torch.Tensor:
    """`loss_fn` over a mesh (transformer.sharded_lm_loss): each Mamba-2
    layer's heads over `model` (ssm.sharded_mamba2); the shared block
    (transformer.sharded_block: its heads through B9, its MLP columns)
    is one tree of ``Sharded`` leaves used by every super-block, so each
    use's gradient sums into the one owner."""
    mamba = T.per_group(functools.partial(_sharded_mamba_block, cfg))
    shared = T.per_group(functools.partial(T.sharded_block, cfg))
    units = []
    for sb in layer_list(params["mamba"], n_superblocks(cfg)):
        units += [(mamba, lp) for lp in layer_list(sb, cfg.attn_every)]
        units.append((shared, params["shared"]))
    return T.sharded_lm_loss(cfg, params, batch, mesh, plan, units)


# --- serving -------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """{"mamba": {"ssm", "conv"} [NS, attn_every, B, ...], "k", "v":
    [NS, B, max_len, KH, hd]} zeros (no "length" leaf)."""
    NS = n_superblocks(cfg)
    st = ssm.mamba2_state(cfg, batch, dtype, device)
    mamba = {k: torch.zeros((NS, cfg.attn_every) + v.shape, dtype=v.dtype,
                            device=v.device) for k, v in st.items()}
    kv = attn.init_kv_cache(cfg, batch, max_len, layers=NS, dtype=dtype,
                            device=device)
    return {"mamba": mamba, "k": kv["k"], "v": kv["v"]}


def decode_step(cfg, params, cache: Params, token: torch.Tensor, pos
                ) -> Tuple[torch.Tensor, Params]:
    """One token a sequence (token [B]) at the scalar position `pos`
    (an int or a 0-d device tensor: every sequence at one length).
    Each super-block's shared attention writes its k/v at `pos` and
    attends positions <= pos.  Returns (logits [B, vocab], cache), the
    cache updated in place."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).to(torch.int32)
    x = _embed(params, token)[:, None, :]
    positions = pos.reshape(1, 1).expand(B, 1)
    sp = params["shared"]
    for s in range(n_superblocks(cfg)):
        sb = layer_slice(params["mamba"], s)
        for i in range(cfg.attn_every):
            lp = layer_slice(sb, i)
            st = {k: leaf[s, i] for k, leaf in cache["mamba"].items()}
            h = apply_norm(cfg, x, lp["ln"])
            y, new = ssm.mamba2_mixer(cfg, lp["mixer"], h, state=st)
            for k in st:
                st[k].copy_(new[k])
            x = x + y
        # shared attention with this super-block's KV cache slice
        h = apply_norm(cfg, x, sp["ln1"])
        q, k1, v1 = attn.qkv_project(cfg, sp["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k1 = apply_rope(k1, positions, cfg.rope_theta)
        ck, cv = attn.update_cache(cache["k"][s], cache["v"][s], k1, v1, pos)
        o = attn.decode_attention(q, ck, cv, pos + 1)
        x = x + attn.out_project(sp["attn"], o)
        h = apply_norm(cfg, x, sp["ln2"])
        x = x + mlp_mod.mlp(cfg, sp["mlp"], h)
    x = apply_norm(cfg, x, params["final_norm"])
    return logits_fn(cfg, params, x)[:, 0], cache
