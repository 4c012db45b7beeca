"""Encoder-decoder transformer (whisper-small backbone).

PyTorch counterpart of ``repro/models/encdec.py``.  The conv/audio
frontend is a stub: the batch carries precomputed frame embeddings
``frames`` [B, S_enc, d] (``api.input_specs`` / ``api.make_batch``).
Encoder layers are bidirectional; decoder layers run causal
self-attention, then cross-attention to the encoder output.  LayerNorm,
GELU, biases and learned absolute positions, as the config says; the
unembedding is the token embedding (tied).

Layer parameters keep the reference's stacked layout (``enc_layers`` /
``dec_layers``, a leading [L] axis), so its weights bridge unchanged
(``convert.from_reference``); its scans over layers are Python loops
under the config's remat policy.  Every attention over a whole sequence
(the encoder's, the decoder's causal self-attention, cross-attention) is
``attention.flash_attention``: B9 on the card.  Serving keeps the
decoder's self K/V [L, B, min(max_len, max_target_len), KH, hd] and the
cross K/V that ``prefill`` computes once from the encoder output, all
updated in place, so a decode step can be captured as one CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import (ParamSpec, apply_norm, cross_entropy,
                                       norm_spec)
from repro_torch.models.transformer import (_remat, embed_tokens,
                                            layer_list, layer_slice,
                                            stack_specs)

Params = Dict[str, Any]


def enc_layer_specs(cfg) -> Params:
    return {
        "ln1": norm_spec(cfg, cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "ln2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


def dec_layer_specs(cfg) -> Params:
    return {
        "ln1": norm_spec(cfg, cfg.d_model),
        "self_attn": attn.attn_specs(cfg),
        "ln2": norm_spec(cfg, cfg.d_model),
        "cross_attn": attn.attn_specs(cfg),
        "ln3": norm_spec(cfg, cfg.d_model),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


def encdec_specs(cfg) -> Params:
    return {
        "embed": ParamSpec((cfg.padded_vocab_size, cfg.d_model),
                           ("vocab", "embed"), scale=0.02),
        "enc_pos": ParamSpec((cfg.max_source_len, cfg.d_model),
                             (None, "embed"), scale=0.02),
        "dec_pos": ParamSpec((cfg.max_target_len, cfg.d_model),
                             (None, "embed"), scale=0.02),
        "enc_layers": stack_specs(enc_layer_specs(cfg), cfg.enc_layers),
        "dec_layers": stack_specs(dec_layer_specs(cfg), cfg.dec_layers),
        "enc_norm": norm_spec(cfg, cfg.d_model),
        "final_norm": norm_spec(cfg, cfg.d_model),
        # whisper ties the unembedding to the token embedding
    }


def _self_block(cfg, p, x: torch.Tensor, *, causal: bool) -> torch.Tensor:
    q, k, v = attn.qkv_project(cfg, p, x)
    o = attn.flash_attention(q, k, v, causal=causal)
    return attn.out_project(p, o)


def _cross_block(cfg, p, x: torch.Tensor, enc_out: torch.Tensor
                 ) -> torch.Tensor:
    """Cross-attention: q from the decoder rows, k/v from `enc_out`, no
    mask.  B9 takes one dtype, so q, k and v meet in the promoted dtype
    (the reference's flash promotes inside) and the output comes back in
    the decoder's."""
    dt = x.dtype
    q = attn._proj(x, p["wq"])
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
    k, v = attn.cross_kv(cfg, p, enc_out, dt)
    ct = torch.promote_types(q.dtype, k.dtype)
    o = attn.flash_attention(q.to(ct), k.to(ct), v.to(ct), causal=False)
    return attn.out_project(p, o.to(dt))


def _enc_block(cfg, lp, x: torch.Tensor) -> torch.Tensor:
    x = x + _self_block(cfg, lp["attn"], apply_norm(cfg, x, lp["ln1"]),
                        causal=False)
    return x + mlp_mod.mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))


def _dec_block(cfg, lp, x: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    x = x + _self_block(cfg, lp["self_attn"], apply_norm(cfg, x, lp["ln1"]),
                        causal=True)
    x = x + _cross_block(cfg, lp["cross_attn"],
                         apply_norm(cfg, x, lp["ln2"]), enc_out)
    return x + mlp_mod.mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln3"]))


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, d] (the stub frontend's output) -> the encoder's
    final hidden [B, S_enc, d] in frames' dtype."""
    S = frames.shape[1]
    x = frames + params["enc_pos"][:S].to(frames.dtype)[None]
    blk = _remat(cfg, functools.partial(_enc_block, cfg))
    for lp in layer_list(params["enc_layers"], cfg.enc_layers):
        x = blk(lp, x)
    return apply_norm(cfg, x, params["enc_norm"])


def decode(cfg, params, tokens: torch.Tensor,
           enc_out: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] (teacher-forced) against `enc_out` -> the decoder's
    final hidden [B, S, d], bf16 whatever the weights' dtype."""
    S = tokens.shape[1]
    x = embed_tokens(cfg, params, tokens)
    x = x + params["dec_pos"][:S].to(x.dtype)[None]
    blk = _remat(cfg, functools.partial(_dec_block, cfg))
    for lp in layer_list(params["dec_layers"], cfg.dec_layers):
        x = blk(lp, x, enc_out)
    return apply_norm(cfg, x, params["final_norm"])


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean cross-entropy of the decoder over the padded vocab (the
    logsumexp takes the padding columns too, as the reference's)."""
    enc_out = encode(cfg, params, batch["frames"])
    h = decode(cfg, params, batch["tokens"], enc_out)
    logits = h @ params["embed"].T.to(h.dtype)
    return cross_entropy(logits, batch["labels"])


# --- sharded training over a (data, model) mesh --------------------------

def _sharded_enc_block(cfg, g, lp, xd, read):
    """An encoder layer of one data group: its heads (non-causal, no
    RoPE) and MLP columns on each `model` worker (transformer's
    `attn_residual` / `mlp_residual`)."""
    xd = T.attn_residual(cfg, g, lp["attn"], xd,
                         T.norm(cfg, g, lp["ln1"], xd, read), read,
                         rope=False, causal=False)
    return T.mlp_residual(cfg, g, lp["mlp"], xd,
                          T.norm(cfg, g, lp["ln2"], xd, read), read)


def _sharded_dec_block(cfg, g, lp, xd, enc, read):
    """A decoder layer of one data group: causal self-attention, then
    cross-attention (each worker's q heads against k/v its heads project
    from the encoder output `enc`, whole on each of the group's
    devices), then the MLP."""
    xd = T.attn_residual(cfg, g, lp["self_attn"], xd,
                         T.norm(cfg, g, lp["ln1"], xd, read), read,
                         rope=False)
    xd = T.attn_residual(cfg, g, lp["cross_attn"], xd,
                         T.norm(cfg, g, lp["ln2"], xd, read), read,
                         rope=False, kv=enc)
    return T.mlp_residual(cfg, g, lp["mlp"], xd,
                          T.norm(cfg, g, lp["ln3"], xd, read), read)


def sharded_loss_fn(cfg, params, batch: Dict[str, torch.Tensor], mesh,
                    plan) -> torch.Tensor:
    """`loss_fn` over a mesh (transformer.sharded_loss_fn's design): the
    frames' and the tokens' rows split over the plan's batch axes into
    data groups; `enc_pos` / `dec_pos` gathered when used; each `model`
    worker runs its heads of the encoder's self-attention, the decoder's
    causal self-attention and the cross-attention, and its MLP columns;
    the tied, padded-vocab embedding and cross-entropy vocab-parallel
    (the log-sum-exp takes the padding columns, as `loss_fn`)."""
    frames, tokens = batch["frames"], batch["tokens"]
    B, S = tokens.shape
    S_enc = frames.shape[1]
    groups = T._groups(mesh, plan, B)
    spact_enc = T._spact(cfg, plan, mesh, S_enc)
    spact = T._spact(cfg, plan, mesh, S)
    read = T._Reader()
    xs, ys = [], []
    for g in groups:
        lo, hi = g.rows
        f = {d: frames[lo:hi].to(d) for d in g.devices}
        xd = {d: f[d] + read(params["enc_pos"], g.first[d])[:S_enc]
              .to(f[d].dtype)[None] for d in g.devices}
        xs.append(T._exit(g, xd, spact_enc))
        yd = T._sharded_embed(cfg, g, params, tokens[lo:hi], None, read)
        yd = {d: yd[d] + read(params["dec_pos"], g.first[d])[:S]
              .to(yd[d].dtype)[None] for d in g.devices}
        ys.append(T._exit(g, yd, spact))
    enc = T._remat(cfg, functools.partial(
        T.per_group(functools.partial(_sharded_enc_block, cfg)), groups,
        spact_enc))
    for lp in layer_list(params["enc_layers"], cfg.enc_layers):
        xs, _ = enc(lp, xs)
    encs = [T.norm(cfg, g, params["enc_norm"], T._entry(g, x, spact_enc),
                   read) for g, x in zip(groups, xs)]
    dec = T._remat(cfg, functools.partial(
        T.per_group(functools.partial(_sharded_dec_block, cfg)), groups,
        spact))
    for lp in layer_list(params["dec_layers"], cfg.dec_layers):
        ys, _ = dec(lp, ys, encs)
    return T.sharded_lm_head(cfg, params, groups, ys, batch["labels"],
                             spact, 0, mesh.positions[0]) / (B * S)


# --- serving -------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """{"k", "v"} [L, batch, min(max_len, max_target_len), KH, hd] and
    the cross K/V {"xk", "xv"} [L, batch, max_source_len, KH, hd],
    zeros."""
    L, KH, hd = cfg.dec_layers, cfg.num_kv_heads, cfg.head_dim
    T = min(max_len, cfg.max_target_len)

    def zeros(n):
        return torch.zeros((L, batch, n, KH, hd), dtype=dtype, device=device)

    return {"k": zeros(T), "v": zeros(T),
            "xk": zeros(cfg.max_source_len), "xv": zeros(cfg.max_source_len)}


def prefill(cfg, params, frames: torch.Tensor, cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Encode `frames` [B, S_enc, d] and write each decoder layer's cross
    K/V into the first S_enc rows of the cache's cross buffers, in place.
    Returns (enc_out, cache) where the returned cache's "xk" / "xv" are
    views of exactly those S_enc rows (the reference replaces them with
    arrays of S_enc rows): a decode step attends the S_enc encoder
    positions and never the rows past them."""
    B, S = frames.shape[:2]
    xk, xv = cache["xk"], cache["xv"]
    if xk.ndim != 5 or xk.shape[1] != B or xk.shape[2] < S:
        raise ValueError(
            f"prefill writes the cross K/V of {S} frames into a cache "
            f"[L, {B}, >= {S}, KH, hd], not {tuple(xk.shape)} "
            f"(init_cache)")
    xk, xv = xk[:, :, :S], xv[:, :, :S]
    enc_out = encode(cfg, params, frames)
    for i in range(cfg.dec_layers):
        lp = layer_slice(params["dec_layers"], i)
        k, v = attn.cross_kv(cfg, lp["cross_attn"], enc_out,
                             enc_out.dtype)
        xk[i].copy_(k)
        xv[i].copy_(v)
    return enc_out, dict(cache, xk=xk, xv=xv)


def decode_step(cfg, params, cache: Params, token: torch.Tensor, pos
                ) -> Tuple[torch.Tensor, Params]:
    """One token a sequence (token [B]) at the position `pos` (an int, a
    0-d or a [1] device tensor: every sequence at one length), clamped to
    max_target_len - 1.  Each layer writes its self k/v at `pos` and
    attends positions <= pos, then attends every row of the cross K/V.
    Returns (logits [B, vocab_size], cache), the cache updated in place.
    No host read: the step can be captured as one CUDA graph."""
    pos = torch.as_tensor(pos, device=token.device).to(torch.int32)
    pos = pos.reshape(()).clamp(max=cfg.max_target_len - 1)
    x = embed_tokens(cfg, params, token)[:, None, :]             # [B,1,d]
    x = x + params["dec_pos"].index_select(0, pos.reshape(1)).to(
        x.dtype)[None]
    S_enc = cache["xk"].shape[2]
    for i in range(cfg.dec_layers):
        lp = layer_slice(params["dec_layers"], i)
        h = apply_norm(cfg, x, lp["ln1"])
        q, k1, v1 = attn.qkv_project(cfg, lp["self_attn"], h)
        ck, cv = attn.update_cache(cache["k"][i], cache["v"][i], k1, v1, pos)
        o = attn.decode_attention(q, ck, cv, pos + 1)
        x = x + attn.out_project(lp["self_attn"], o)
        # cross-attention against the prefilled encoder K/V
        h = apply_norm(cfg, x, lp["ln2"])
        q = attn._proj(h, lp["cross_attn"]["wq"])
        if cfg.use_bias:
            q = q + lp["cross_attn"]["bq"].to(h.dtype)
        o = attn.decode_attention(q, cache["xk"][i], cache["xv"][i], S_enc)
        x = x + attn.out_project(lp["cross_attn"], o)
        h = apply_norm(cfg, x, lp["ln3"])
        x = x + mlp_mod.mlp(cfg, lp["mlp"], h)
    x = apply_norm(cfg, x, params["final_norm"])
    logits = (x @ params["embed"].T.to(x.dtype))[:, 0, :cfg.vocab_size]
    return logits, cache
